#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: the codec's decode
path and its encode (training) path, the runner's single-model fit of the
KAN and of the production mlp, the sharded fits on two ranks that share
the card, the rest of the codec, the spectral fits, the precision
schedule, the profiler and the rest of the model zoo and the runner, the
whole-signal losses on a mesh, a window population's other losses, and
the KAN at any grid size and orders up to 8.

    python3 chip_smoke.py

Drives ``inraudio_tpu_torch`` (never JAX) through its user entry points,
random weights from a fixed torch.Generator seed, on a synthesised 7 s,
44.1 kHz clip.  The codec runs at its production width (SirenWithSnakeTanh,
h=128, 2 sine + 2 snake layers) at two shapes:

- headline shape: 512-row windows, overlap 0.1 (hop 461), k=669,
  omega0=115, float32 leaves, legacy npz container; trained with the
  bench recipe (lr 1.5e-3, clip 1.0, plateau patience 35);
- codec default shape: 0.25 s windows (11,025 rows), k=31, omega0=1800,
  float16 weights, INRA container; trained with CodecConfig defaults.

Phases, each of which fails the run:
0. build the CUDA kernels from csrc/ (one nvcc per library, in parallel;
   kan.cu twice: the default library and the wide one, -DKAN_WIDE=1),
   print ptxas's register and spill lines, and the count of HMMA/HGMMA
   instructions in the SASS of the tensor-core kernels: G's and H's, every
   instance of the SIREN grad kernel's sweep and dW kernels, and the stack
   forward's tensor-core kernel at every width (cuobjdump -sass beside
   nvcc; none in any of them fails the run);
1. per shape and per decode tier, the stack kernel against its plain
   PyTorch version on the card, max-abs within the stated tolerance, with
   the route of each call (``stack_launch``: the tensor-core kernel in the
   bf16 tiers, the FMA kernel where a layer is highest; phases 4, 11 and 13
   print theirs too);
2. serving decode: full decode, three decode_range seeks (must equal the
   full decode's slice), an upsample=2 decode and a CLI subprocess, with
   the stack kernel's launch count read around the in-process requests;
   the decode is checked against the exact apply on the card and against
   the CPU plain path on a small range;
3. the card-only pytest file (tests/test_torch_cuda.py);
4. decode timings with CUDA events: kernel vs plain, and the stitched
   decode;
5. at the headline shape, the whole-step kernel (D) against the plain step
   over 3 steps from one state, the backward kernel (C) against the plain
   backward, and two kernel steps from one state, which must be bit-equal;
6. serving encode, with every kernel's launch count read around it:
   codec.encode(fused=True) at the headline shape -> save_inr -> load_inr
   -> codec.decode on the card, with the SNR against the clip; and the CLI
   ``encode --device cuda --fused --quantize int8 --refit-steps 50`` at the
   codec default shape (in process, so that its launches are counted).
   Then the same headline fit through the plain step from the same
   initial parameters, for two seeds: at 150 steps the two decoded clip
   SNRs must agree within 0.5 dB; at 300 steps, where a few windows'
   trajectories have parted, the median per-hop SNRs within 1 dB.  Beside
   each pair, a control: the kernel fit from the init times 1 + 2^-22;
7. training timings with CUDA events: D vs the plain step and C vs the
   plain backward at the headline shape, the grad accumulation's kernels
   (weight split, sweep, dW), the reduce and the epilogue (clip + Adam +
   best: ``launch_adam``'s scale and Adam kernels, timed directly, against
   their byte bound) apart beside the step's plane and slab bytes, and the
   fit's steps/s and peak device memory at both shapes.

The KAN fit (the runner's ``fit --arch kan``), at the runner shape
KAN([1, 256, 256, 1]) over the same clip (308,207 rows, f32, weights from
seed 0), with ``csrc/kan.cu`` built in phase 0 beside the other sources:
8. kernel G (forward) and kernel H (backward) against their plain versions
   over the full clip, the cotangent that of the MSE loss against the
   clip; two G calls from one input and two H calls from one state, each
   pair bit-equal;
9. served through the entry points, in process, with the launch counts set
   to 0 before and read after: the CLI ``fit --device cuda --arch kan
   --fused --hidden 256`` on the clip as a wav (KAN_FIT_STEPS steps), whose
   checkpoint is loaded and decoded through ``eval.decode.decode_problem``;
   the same CLI with the RFF recipe ``--num-freq 256 --sigma 1500 --hidden
   128`` (KAN(512, 128, 128, 1)); then a kernel fit and a plain-version fit
   from one initial state (KAN_CMP_STEPS steps), whose final losses must
   agree within a limit set from a 1-ulp-perturbed kernel fit beside them;
10. timings with CUDA events: G, H and a whole KAN step against their plain
   versions, each layer's G with its route against its plain version and
   H's parts (the cotangent's bf16 split, dW, the fixed-order reduce, W's
   split for dx, dx), the fit's steps/s and its peak device memory.

The runner's production mlp (``fit --arch mlp --fused`` at the CLI's
defaults: h=256, omega0=22000, hidden omega 30, a_initial 0.5, 2 sine + 2
snake layers and a linear head) over the same clip as one full batch
(308,207 rows), on raw coordinates ("runner mlp") and with ``--num-freq
256`` at sigma 10 ("runner mlp RFF": in_features 512, the model owns B and
the kernels compute the features in layer 0), weights from seed 0:
11. per shape, the stack kernel against its plain version in every decode
   tier the gate can pick, with layer 0's pre-activation held to a few
   ulps and the output to RUNNER_CTRL_X times a control (the plain
   version with layer 0's W and b one ulp off: at omega0 = 22000 the two
   summation orders of layer 0 differ by about that much); kernel C and
   kernel D (3 steps) against their plain versions beside the same
   control; two D steps from one state, which must be bit-equal;
12. served through the entry points, in process, with every launch count
   set to 0 before and read after: the CLI ``fit --device cuda --arch mlp
   --fused`` at its defaults and the same with ``--num-freq 256``
   (RUNNER_FIT_STEPS steps each), the RFF fit's checkpoint -> load ->
   ``decode_problem``; RUNNER_AUTOGRAD_STEPS autograd steps of each model
   (``train.loop.make_train_step``: the stack forward and kernel C, the
   JAX package's route for the RFF model at h=256); then a kernel fit and a
   plain-step fit of the RFF model from one state (RUNNER_CMP_STEPS steps)
   beside a 1-ulp-perturbed kernel fit, as phase 9;
13. timings with CUDA events at both shapes: the stack kernel, C and D
   against their plain versions and bounds, the step's split into grad
   accumulation (weight split, sweep, dW), reduce, clip + Adam + best (its
   device time, ``device_ms``) and bookkeeping, the step's plane and slab bytes, and the fit's steps/s and
   peak device memory against the grad scratch bound (SCRATCH_BYTES +
   PLANE_BYTES + state-sized groups).

The sharded fits (``fit(mesh=...)`` and ``multi_inr_fit(mesh=...)``), at the
runner mlp shapes above and the headline encode, with two ranks that share
the card: threads of this process, each with its own gloo group
(``run_thread_ranks`` of tests/test_torch_cuda.py), the all-reduce staged
through host memory:
14. kernel E (``SIREN_GRAD``) on each of the fit's two row shards against
   its plain version beside the 1-ulp control of phase 11, the two shards'
   sum against D's grad accumulation over the whole clip, a shard with
   limit 0 (exact zeros), two E calls (bit-equal); kernel F
   (``SIREN_ADAM``) against ``adam_epilogue_plain`` on the all-reduced
   buffer, with and without the best snapshot and the clip;
15. served, with every launch count set to 0 before and read after each
   run: the runner mlp raw and RFF fits on two ranks (RUNNER_SHARD_STEPS
   steps: E and F launch once a step on each rank, D not at all; the first
   loss within 1e-5 of the one-rank D fit's, the final loss within the
   1-ulp control rule of phase 12, both ranks' states bit-equal), and, on a
   machine with several cards, the same fits held to the same gates on
   min(cards, 4) ranks with a card each (NCCL): this script under
   ``torchrun``, each rank in ``sharded_fits_rank``; KAN_SHARD_STEPS
   autograd steps of the runner KAN on two ranks (G and H per shard); the
   headline encode with its 669 windows sharded over two ranks (every
   window's loss history bit-equal to one rank's); the CLI ``fit`` under
   ``torchrun --nproc-per-node 2`` on one card (gloo);
16. timings: E per shard (and its weight split, sweep, dW and reduce
   apart, with the shard's plane and slab bytes), the gloo all-reduce, F
   and its plain version, the sharded step against the one-rank D step.
   F's device time comes from F_ITERS raw entry launches
   (``lib.siren_adam_global``, no Python checks) queued behind a sleep
   kernel (``device_ms``), hot and with FLUSH_BYTES rewritten between
   launches outside the events, at clip 0 and 1.0, against its byte
   bound; ``SIREN_ADAM``'s host time a call apart; and
   ``torch.optim.Adam(fused=True).step()`` on one P-float tensor timed the
   same two ways.

The codec's rate points below the kernel width (h = 36, 40 and 48, which
the kernels run zero-padded to 64 with the model's own width passed to the
training kernels):
17. codec.encode(fused=True) at each point of WIDTH_POINTS (0.5 s windows,
   WIDTH_STEPS steps, the refit through C where the point has one) with
   every launch count read around it, the payload decoded on the card
   through the stack kernel and held to the plain version's decode (its
   samples at phase 1's tolerance for the decode's tier, and its SNR); at
   h = 36, C against its plain backward on the refit's inputs (the
   payload's dequantized params padded to 64, the refit's coords, the
   gradient of its loss), with every padded slot's gradient exactly 0;
   then, at each width, 3 steps of D against 3 plain steps from one padded
   flat state (phase 5's tolerance), and WIDTH_D_STEPS steps of D, after
   which every padded slot of params, best, mu and nu must be bit-zero
   (padded snake a bit-one).

The rest of the codec (the modulated family, rate planning, the decode
serving paths, fit-multi):
18. the CLI ``encode --modulated`` (h=64 int8 modulations with a 100-step
   backbone refit, and a segmented h=128 int16 form), MOD_STEPS steps each,
   decoded on the card and held to the CPU's decode (TRAINED_ATOL) and
   three ``decode_range`` seeks to the full decode's slice; then
   ``--target-bps 1.5`` must plan the modulated family and ``--target-bps
   4 --fused`` the per-window one (through kernel D, its launches
   counted); each payload's bits/sample on disk and SNR are printed beside
   the JAX package's TPU calibration, with no gate on them;
19. ``decode_many`` over the trained headline, codec-default and modulated
   payloads (the headline twice): each output equal to its own ``decode``
   byte for byte, with one stack-kernel launch per group; ``decode_stream``
   against ``decode``; ``decode_many`` against N decodes timed with CUDA
   events; and each decode tier's SNR against the exact apply on the
   trained headline and codec-default payloads, beside the routing
   table's floor;
20. the CLI ``fit-multi --fused --device cuda`` at the headline shape for
   FIT_MULTI_STEPS steps, with kernel D's and A's launches counted and the
   metrics file's round records checked.

The spectral fits (the runner's ``fit --method mdct|fft|multi`` and the
loss zoo) at the CLI's defaults (the production mlp, h=256, omega0=22000)
on the same clip, the mdct target at n=2048: 1,024 bins x 300 frames =
307,200 rows of two coordinates, its hearing-threshold mask the per-row
loss weight:
21. kernel D with the weight, 3 steps from one state against ``step_plain``
   with the weight beside the 1-ulp control (phase 11's rule), in the
   default grad tier (the tensor-core route) and for one step in the
   highest tier (the FMA kernel), both at d = 2; an all-ones weight
   against no weight (loss, params, mu, nu, best bit-equal); two weighted
   steps from one state (bit-equal); kernel E with the weight on the two
   shards of a 2-rank fit against ``grad_plain`` beside the control, the
   shards' sum against D's weighted grad accumulation, a shard with limit
   0 (exact zeros); a negative control for each (the plain step or grad
   without the weight against the plain one with it, which must break the
   gates the kernel is held to, so a kernel that dropped the weight could
   not pass);
22. served through the entry points, in process, every launch count set to
   0 before and read after each: the CLI ``fit`` with ``--method mdct
   --perceptual-mask`` (D with the weight), ``--method mdct --adaptive
   --takelog``, ``--method fft --loss-mode mae`` (autograd: the stack
   kernel and C), ``--method wave --alpha 0.5 --multi-resolution-stft``
   (autograd with the STFT term), ``--method multi`` and ``--arch kan
   --method mdct`` (G and H at d = 2), SPECTRAL_STEPS steps each, each
   checkpoint loaded and decoded by ``decode_problem`` on the card (SNR
   printed, not gated: the fft figure is phase-limited) and on the CPU's
   plain versions (SPECTRAL_DECODE_RTOL of the largest sample; the fft
   decode by Griffin-Lim's spectral convergence); then the weighted mdct
   fit on two thread ranks (E + F, never D), its first and final loss held
   to the one-rank weighted fit beside a 1-ulp control (phase 15's rule);
23. timings with CUDA events: the weighted D step against the unweighted
   one at the mdct shape with their sweeps apart, weighted E on a shard,
   the autograd ``mae`` (fft target) and STFT-loss (wave) steps split into
   the stack forward, the loss with its gradient, and C; ``stmdct``,
   ``istmdct``, ``stft_magnitude`` and 60 Griffin-Lim iterations on the
   card, basis matmul against ``torch.fft``; each served fit's peak device
   memory against the grad scratch bound.

The precision schedule (``TrainConfig.precision_schedule``: rounds on the
cheap tier of ``train.loop.schedule_tiers`` -- bf16x2 forward products, one
bf16 pass for the backward, the degree-7 sin -- until a round's loss
crosses ``schedule_db``), the profiler and the rest of the runner, at the
runner mlp shapes over the same clip:
24. per shape (raw and RFF), kernel D on the cheap tier, one step from one
   state against ``step_plain`` on the same tier beside the 1-ulp control
   of phase 11 (a raw layer 0 also to the bf16 grad tiers' bulk rule of
   tests/test_torch_cuda.py); E on one shard of two the
   same way against ``grad_plain``; a negative control for each (the
   cheap kernel against the full tier's plain version, which must break a
   gate); repeat calls bit-equal; two cheap steps, then a full step on the
   same carry, bit-equal to a fresh full step; timings with CUDA events of
   both tiers' D step (with the sweep's parts), E and their plain versions
   beside their bounds;
25. ``fit(precision_schedule=True)`` of the raw runner mlp, SCHEDULE_STEPS
   steps in rounds of SCHEDULE_CHUNK, with D's (or E's) launches counted by
   tier around every call: unscheduled, at the default 45 dB (no
   escalation on this clip), at a floor between the unscheduled fit's
   first two round-end losses (the escalation on the card, at the round
   the rule gives on the fit's own printed losses), and that fit on two
   ranks sharing the card (E + F, gloo; both ranks escalate at one round,
   their states bit-equal); steps/s and peak memory of each; then the CLI
   ``fit --fused --profile --no-plots`` (PROFILE_STEPS steps), whose trace
   must name ``siren_sweep_kernel``;
26. the classic SIREN and the ReLU MLP at their configs' defaults (h=256,
   3 hidden layers) fitted by ``fit`` over the whole clip (ZOO_STEPS
   steps), the CLI ``fit --scaled-first`` (unfused: autograd), the
   ``random_plane`` scan (LANDSCAPE_STEPS x LANDSCAPE_STEPS, distance 2) of
   the trained runner mlp with B's launches counted, ``procedural_train``
   (decimations 8, 4, 2, 1) and ``band_split_train`` (PIPELINE_STEPS steps
   a fit), each with its time and peak device memory; the plots and
   ``--visualization`` where matplotlib is installed.

The losses that need the whole signal on a mesh, a window population's
other losses, and the KAN at grid extension's sizes and orders:
27. ``fit`` on two thread ranks sharing the card (gloo) with the snr loss
   (the runner mlp on the clip, cut to an even 308,206 rows so that the
   gathered clip is the one rank's), the wave target with alpha 0.5 and
   the multi-resolution STFT term, the mdct target with its
   hearing-threshold weight and the snr loss, and the runner KAN with the
   snr loss, MESH_LOSS_STEPS steps each: every rank runs B (G) on its
   shard, gathers the prediction of the whole clip, takes the loss and its
   cotangent, and runs C (H) on its rows' part; each fit against the same
   fit on one rank beside its 1-ulp control (phase 15's rule, and at least
   SNR_FLOOR_DB for the snr loss), the ranks bit-equal, B and C (G and H)
   launched once a step on each rank; and the parts of the sharded step
   itself on rank 0 (forward, gather, loss, backward, all-reduce, update;
   ``make_sharded_train_step``'s ``mark``);
28. a window population's mae and snr (the headline windows) and alpha 0.5
   with the multi-resolution STFT term (the codec-default windows) through
   ``make_train_step``: the stack kernel (A) and kernel C once a step, the
   first losses against the plain forward's beside a 1-ulp control, C on
   the step's cotangent against its plain version in the step's grad tier
   and in the highest (the tier's rule, or POP_ORDER_X times the plain
   version's gap to itself with its rows and hidden units summed in
   another order), the step against the plain forward and backward; and
   the 512-row headline windows with alpha > 0, which raise as in the JAX
   package;
29. the runner KAN at grid 5 / order 3 through both builds of kan.cu
   (timed, outputs bit-equal); its widths at grid 20 / order 3, grid 5 /
   order 5 (whole
   clip fits of 30 steps, the grid 20 fit refreshing its grid every 10
   steps), grid 100 / order 3 and grid 5 / order 8 (fits of 5 steps): G and
   H against their plain versions on a KAN_SUBSET_ROWS-row subset, at the
   init and after ``update_grid``, repeat calls bit-equal, the fits'
   launches, and G, H and each layer timed over the whole clip against
   ``kan_bounds`` at the config's J.

Every kernel's bound (the least time the card could take for the same
work) is computed from the run's shapes: the larger of the bytes it must
move over 3.35 TB/s and its operations over the peak of the unit they
could use (989 TFLOP/s bf16 tensor cores for the bf16-split products,
67 TFLOP/s fp32 for the elementwise work), at the published 700 W rates.

Exits non-zero, printing no result, without CUDA or outside the repo.  The
last line is the JSON result; the line before it lists the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
SEED = 0
FS = 44100
CLIP_SAMPLES = 308_207
SHAPES = {
    "headline": dict(chunk_seconds=512 / FS, overlap=0.1, omega=115.0,
                     quantize=None, fit_snr_db=90.0, file="headline.npz",
                     expect=(512, 461, 669)),
    "codec_default": dict(chunk_seconds=0.25, overlap=0.1, omega=1800.0,
                          quantize="float16", fit_snr_db=60.0,
                          file="codec_default.inra",
                          expect=(11025, 9923, 31)),
}
# decode tiers selected through the header's fit_snr_db (auto_decode_kwargs
# adds 6 dB routing slack and a 9 dB margin; deg 11 serves needs up to its
# 110.51 dB floor, measured in phase 19)
TIER_FITS = {"bf16-deg7": 20.0, "mixed-bf16x2-deg7": 30.0, "deg9": 60.0,
             "deg11": 90.0, "exact": 130.0}
# training recipes: bench.py's headline, and CodecConfig's defaults
TRAIN = {"headline": dict(learning_rate=1.5e-3, grad_clip_norm=1.0,
                          plateau_patience=35),
         "codec_default": dict(learning_rate=7e-4, grad_clip_norm=1.0,
                               plateau_patience=200)}
FIT_STEPS = 300       # the served headline encode
CLI_STEPS = 200       # the CLI encode at the codec default shape
CMP_STEPS = 150       # kernel vs plain-step fit, clip SNR compared
CMP_SEEDS = (SEED, SEED + 1)
SNR_AGREE_DB = 0.5    # at CMP_STEPS, as tests/test_pallas_step.py:310
SNR_AGREE_DB_MEDIAN = 1.0  # median per-hop SNR at FIT_STEPS
# the KAN fit: the runner's KAN([1, h, h, 1]) at its default h
KAN_LAYERS = (1, 256, 256, 1)
KAN_FIT_STEPS = 100   # each CLI fit (a depth cut: the run stays near
#                       half its time limit)
KAN_CMP_STEPS = 40    # kernel vs plain-version fit
# the kernel and plain fits' final losses may differ by this many times the
# 1-ulp control's gap, or by this relative floor, whichever is larger (on
# the H100 the two fits agreed to 9 digits over 40 steps while the control
# moved the loss by 1.5e-7 of itself)
KAN_CMP_CONTROL_X = 10.0
KAN_CMP_FLOOR_REL = 1e-6
# the runner's production mlp (phases 11-13)
RUNNER_H = 256
RUNNER_OMEGA = 22000.0
RUNNER_NUM_FREQ = 256
RUNNER_SIGMA = 10.0
RUNNER_FIT_STEPS = 200     # each CLI fit
RUNNER_AUTOGRAD_STEPS = 5  # autograd steps (stack kernel + C) per shape
RUNNER_CMP_STEPS = 40      # kernel vs plain-step fit
# kernel vs plain at omega0 = 22000: at most this many times the control's
# gap (the plain version with W0 one ulp off), or the f32 tolerance of the
# card tests, whichever is larger; the same rule as the fits' comparison
RUNNER_CTRL_X = 10.0
# the sharded fits (phases 14-16): steps of each row-sharded runner mlp fit,
# of the sharded KAN fit, of the window-sharded headline encode, and of the
# torchrun CLI fit
RUNNER_SHARD_STEPS = 40
KAN_SHARD_STEPS = 3
ENCODE_SHARD_STEPS = 50
TORCHRUN_STEPS = 20
NCCL_FITS = "nccl_fits.json"  # phase 15's NCCL leg, written by rank 0
# phase 17: the codec's rate points below the kernel width 64 (the JAX
# package's _RD_POINTS, inraudio_tpu/codec.py:122-134: 0.5 s windows, h,
# quantize, refit steps), trained WIDTH_STEPS steps each (a depth cut: the
# points train CodecConfig's 3000); the kernel decode's SNR may differ from
# the plain version's by WIDTH_SNR_DB; C is held to its plain version at
# WIDTH_C_H; WIDTH_D_STEPS steps of D from a flat state, whose padded slots
# must stay bit-zero
WIDTH_POINTS = ((36, "int8", 400), (40, "int8", 400), (48, "int8", 0),
                (48, "float16", 0))
WIDTH_STEPS = 300
WIDTH_SNR_DB = 0.05
WIDTH_C_H = 36
WIDTH_D_STEPS = 100
# phases 18-20: the modulated CLI encodes (each MOD_STEPS steps, a depth
# cut: the table's points train 3000), the JAX package's modulated table
# points they correspond to, and its TPU calibration (disk bits/sample, SNR
# on gt_bach.wav), printed beside the readings; the --target-bps targets
# and the family each must plan; a range against the full decode's slice
# (cuBLAS sums a different window count in another order); the fit-multi
# CLI's steps
MOD_STEPS = 200
MOD_ENCODES = (
    ("mod", ["--chunk-s", "0.05", "--hidden", "64", "--omega", "500",
             "--learning-rate", "1e-3", "--quantize", "int8",
             "--mods-lr-mult", "5", "--refit-steps", "100"], "mod_h64_i8"),
    ("mod_seg", ["--chunk-s", "0.05", "--hidden", "128", "--omega", "500",
                 "--learning-rate", "1e-3", "--quantize", "int16",
                 "--mods-lr-mult", "5", "--segment-s", "1.0"],
     "mod_seg1_h128_i16"))
MOD_TABLE = {"mod_h48_i8": "1.44 bits/sample, 15.4 dB",
             "mod_h64_i8": "2.08 bits/sample, 19.1 dB",
             "mod_seg1_h128_i16": "25.7 bits/sample, 40.8 dB",
             "48 int8": "3.98 bits/sample, 30.6 dB"}
MOD_SEEKS = ((0.5, 0.75), (2.9, 3.1), (6.9, 7.0))
MOD_RANGE_ATOL = 1e-6
TRAINED_ATOL = 3e-5   # tests/test_torch_decode.py
PLAN_TARGETS = ((1.5, "modulated", []), (4.0, "per_chunk", ["--fused"]))
FIT_MULTI_STEPS = 200
# phases 21-23: the spectral fits at the CLI's defaults on the clip: the
# mdct target at n = 2048 (1,024 bins x 300 frames, two coordinates); each
# served CLI fit's steps (a depth cut) and the sharded weighted fit's; each
# fit's kind: (method, arch, extra CLI flags, the builder's knobs they set,
# autograd step); the card's
# decode against the CPU's: SPECTRAL_DECODE_RTOL of the largest sample (the
# stack kernel agrees with its plain version to ~1e-4 of its output at
# omega0 = 22000, phase 11's control), the fft decode's Griffin-Lim by
# spectral convergence within SPECTRAL_GL_MARGIN; the autograd fits' peak
# memory within the grad scratch plus SPECTRAL_ROW_FLOATS floats a row (the
# STFT loss's frames)
SPECTRAL_N = 2048
SPECTRAL_ROWS = (307_200, 2)
SPECTRAL_STEPS = 30
SPECTRAL_SHARD_STEPS = 20
SPECTRAL_FITS = {
    "mdct_mask": ("mdct", "mlp", ["--perceptual-mask"],
                  dict(perceptual_mask=True), False),
    "mdct_adaptive_takelog": ("mdct", "mlp", ["--adaptive", "--takelog"],
                              dict(adaptive=True, takelog=True), False),
    "fft_mae": ("fft", "mlp", ["--loss-mode", "mae"], {}, True),
    "wave_stft": ("wave", "mlp", ["--alpha", "0.5",
                                  "--multi-resolution-stft"], {}, True),
    "multi": ("multi", "mlp", [], {}, False),
    "kan_mdct": ("mdct", "kan", [], {}, False),
}
AUTOGRAD_STEPS = {
    "fft_mae": ("fft", {}, dict(loss_mode="mae")),
    "wave_mrstft": ("wave", {}, dict(alpha=0.5, multi_resolution_stft=True)),
}
SPECTRAL_DECODE_RTOL = 1e-3
SPECTRAL_GL_MARGIN = 0.02
SPECTRAL_ROW_FLOATS = 64
# phases 24-26: the precision schedule's cheap tier (train.loop.
# schedule_tiers), the scheduled fits (rounds of SCHEDULE_CHUNK steps), the
# profiled CLI fit (one round), the zoo fits, the landscape's grid (the
# JAX default) and the pipelines' steps a fit (depth cuts)
CHEAP_TIER = dict(f32_mode="bf16x2", grad_mode="bf16", sin_degree=7)
SCHEDULE_STEPS = 40
SCHEDULE_CHUNK = 10
PROFILE_STEPS = 20
ZOO_STEPS = 20
LANDSCAPE_STEPS = 30
PIPELINE_STEPS = 10
# phases 27-29: the whole-signal losses on two ranks (depth cut to 30
# steps a fit), a window population's other losses (steps through the
# kernels a case), and the KAN at grid extension's sizes and orders:
# (grid_size, spline_order, fit steps over the whole clip, grid refresh
# every so many steps), the kernels held to their plain versions on a
# KAN_SUBSET_ROWS-row subset of the clip
MESH_LOSS_STEPS = 30
# the snr loss near 0 dB moves in steps of 10 / ln 10 x 2^-23 ~ 5.2e-7 dB
# (one f32 ulp of the energy ratio): a final-loss gate never tighter than
# ~20 of them
SNR_FLOOR_DB = 1e-5
MESH_LOSS_FITS = {
    "snr": ("wave", "mlp", dict(loss_mode="snr")),
    "wave_alpha_mrstft": ("wave", "mlp", dict(alpha=0.5,
                                              multi_resolution_stft=True)),
    "mdct_mask_snr": ("mdct", "mlp", dict(loss_mode="snr")),
    "kan_snr": ("wave", "kan", dict(loss_mode="snr")),
}
POP_STEPS = 5
# phase 28's gate on C where the tier's rule does not hold: POP_ORDER_X
# times the plain version's gap to itself with its sums in another order
# (rows and hidden units permuted: the kind of difference the kernel's own
# summation order makes), a limit that must stay under POP_RESOLVE of the
# largest gradient
POP_ORDER_X, POP_RESOLVE = 2.0, 0.1
POP_CASES = {
    "headline_mae": ("headline", dict(loss_mode="mae")),
    "headline_snr": ("headline", dict(loss_mode="snr")),
    "codec_default_alpha_mrstft": ("codec_default", dict(
        alpha=0.5, multi_resolution_stft=True)),
}
KAN_ORDER_CASES = ((20, 3, 30, 10), (5, 5, 30, 0), (100, 3, 5, 0),
                   (5, 8, 5, 0))
KAN_SUBSET_ROWS = 32768
# the CUDA kernel behind each C entry of kan.cu, for the kernels line
KAN_ENTRY_KERNELS = {
    "kan_split": "kan_split_kernel", "kan_gsplit": "kan_gsplit_kernel",
    "kan_bwd_tc": "kan_bwd_tc_kernel | kan_bwd_ws_kernel",
    "kan_reduce": "kan_reduce_kernel",
    "kan_dx_tc": "kan_dx_tc_kernel", "kan_dx": "kan_dx_kernel",
    "kan_dw": "kan_dw_kernel",
    "kan_bwd_narrow": "kan_bwd_narrow_kernel"}
# the CUDA kernels that serve C, D and E in the bf16 grad tiers (the
# highest tier runs siren_grad_kernel in their place), for the kernels line
TC_KERNELS = ["siren_wsplit_kernel", "siren_sweep_kernel", "siren_dw_kernel",
              "siren_reduce_kernel"]
# the CUDA kernels that serve the stack forward (A, B, B-RFF) in the bf16
# tiers (a plan with a highest layer runs siren_stack_kernel in their place)
STACK_KERNELS = ["siren_stack_split_kernel", "siren_stack_tc_kernel"]
# the optimizer epilogue's kernels: D's (after the reduce) and F's
ADAM_KERNELS = ["siren_scale_kernel", "siren_adam_kernel"]
F_KERNELS = ["siren_adam_global_kernel"]
# F's device time (phase 16): back-to-back calls, and the bytes a flush
# writes between calls to evict the 50 MB L2
F_ITERS = 200
FLUSH_BYTES = 128 << 20
# the card's published peaks (NVIDIA H100 SXM, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def synth_clip(np):
    """A 7 s clip: three partials plus a little noise, peak 0.8."""
    rng = np.random.default_rng(SEED)
    t = np.arange(CLIP_SAMPLES) / FS
    sig = (np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(2 * np.pi * 1330.0 * t)
           + 0.25 * np.sin(2 * np.pi * 5100.0 * t)
           + 0.05 * rng.standard_normal(CLIP_SAMPLES))
    return (0.8 * sig / np.max(np.abs(sig))).astype(np.float32)


def make_payload(name, spec, clip, torch, np, codec, build_model,
                 SirenSnakeTanhConfig, MultiINRConfig, chunk_signal):
    mcfg = MultiINRConfig(chunk_seconds=spec["chunk_seconds"],
                          overlap_fraction=spec["overlap"])
    chunks, n, hop = chunk_signal(clip, FS, mcfg)
    k = chunks.shape[0]
    if (n, hop, k) != spec["expect"]:
        raise AssertionError(f"{name}: windows (n, hop, k) = {(n, hop, k)}, "
                             f"expected {spec['expect']}")
    cfg = SirenSnakeTanhConfig(hidden_features=128, num_sine=2, num_snake=2,
                               first_omega_0=spec["omega"],
                               hidden_omega_0=30.0)
    g = torch.Generator().manual_seed(SEED)
    params = build_model("mlp", cfg).init(g, "cpu", windows=k)
    n_params = sum(v.numel() for layer in params["layers"]
                   for v in layer.values())
    if spec["quantize"]:
        params = codec.quantize_inr_params(params, spec["quantize"],
                                           side=True)
    meta = {"format": codec._FORMAT, "sample_rate": FS,
            "signal_length": CLIP_SAMPLES, "chunk_length": n, "hop": hop,
            "num_chunks": k, "num_channels": 1, "quantize": spec["quantize"],
            "per_row_scales": False,
            "side_quantized": bool(spec["quantize"]),
            "trained_forward": "fused_approx",
            "fit_snr_db": spec["fit_snr_db"],
            "model": {"hidden_features": 128, "num_sine": 2, "num_snake": 2,
                      "first_omega_0": spec["omega"],
                      "hidden_omega_0": 30.0}}
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    payload = {"meta": meta, "scales": scales.astype(np.float32),
               "params": params}
    t0 = time.perf_counter()
    path = codec.save_inr(os.path.join(WORK, spec["file"]), payload)
    t1 = time.perf_counter()
    loaded = codec.load_inr(path)
    t2 = time.perf_counter()
    log(f"payload {name}: k={k} n={n} hop={hop} omega0={spec['omega']} "
        f"quantize={spec['quantize']} params={n_params} "
        f"({n_params * 4 / 1e6:.1f} MB as float32) file="
        f"{os.path.getsize(path)} B save {t1 - t0:.2f} s load {t2 - t1:.2f} s")
    return path, loaded, cfg


def cuda_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` calls after a warm-up, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, flush=None):
    """Device ms per call of ``fn`` -> (ms, queued).  The calls are queued
    behind a sleep kernel longer than their host time, so the device runs
    them back to back whatever the host costs: CUDA events around the
    ``iters`` calls (hot L2), or with ``flush`` (a call that rewrites more
    than the L2) events around each call and the flush between calls,
    outside them.  ``queued``: whether the host had queued every call
    before the sleep ended (else the time may hold host gaps)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if flush is not None:
            flush()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(iters if flush is not None else 1)]
    # at most 2 GHz: the sleep lasts at least four times the host time of
    # the calls (the events' records add to it)
    torch.cuda._sleep(int(8e9 * host_s) + 2_000_000)
    if flush is None:
        pairs[0][0].record()
        for _ in range(iters):
            fn()
        pairs[0][1].record()
    else:
        for start, end in pairs:
            start.record()
            fn()
            end.record()
            flush()
    queued = not pairs[0][0].query()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters, queued


def host_ms(torch, fn, iters):
    """Host ms per call of ``fn`` (its enqueue: no synchronise inside)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def tc_split_ms(torch, st, g, coords, flat, iters, **kw):
    """The tensor-core route of one grad_reduce call, timed kernel by
    kernel (CUDA events over ``iters`` runs of each kind's launches, in
    the call's order, after a whole call): {"siren_wsplit", "siren_sweep",
    "siren_dw", "siren_reduce": ms a call}."""
    lib = st.TRAIN_LIBRARY()
    stream = torch.cuda.current_stream().cuda_stream
    launches, _, scratch = st.tc_launches(lib, g, coords, flat, stream, **kw)
    for _, run in launches:
        run()
    names = dict.fromkeys(name for name, _ in launches)
    out = {name: cuda_ms(torch, lambda name=name: [
        run() for kind, run in launches if kind == name], iters)
        for name in names}
    del scratch
    return out


def tc_bytes_line(st, g, gmode):
    """The step's scratch traffic on the tensor-core route against the FMA
    route's per-tile slabs (``st.tc_traffic``), for the logs."""
    t = st.tc_traffic(g, gmode)
    return (f"scratch traffic a call: planes {t['planes'] / 1e9:.3f} GB + "
            f"slabs {t['slabs'] / 1e9:.3f} GB = "
            f"{(t['planes'] + t['slabs']) / 1e9:.3f} GB (the FMA route's "
            f"per-tile slabs {t['fma_slabs'] / 1e9:.3f} GB, "
            f"{t['fma_slabs'] / (t['planes'] + t['slabs']):.1f}x); at "
            f"3.35 TB/s {(t['planes'] + t['slabs']) / 3.35e9:.3f} ms")


def ptxas_lines(build_log):
    """One line per compiled kernel: its (mangled) name, spills and
    registers, from ptxas's -v report."""
    out, name = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "registers" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    lines = {}
    for name, info in out:
        lines.setdefault(name, []).append(info)
    return [f"{name}: {'; '.join(infos)}" for name, infos in lines.items()]


def sass_mma_counts(lib_path):
    """{kernel: tensor-core instructions (HMMA / HGMMA) in its SASS} of a
    built library, from ``cuobjdump -sass`` beside nvcc; None where the
    toolkit has no cuobjdump."""
    from inraudio_tpu_torch.ops._nvcc import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def bound(bytes_moved, tensor_flop, f32_flop):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and each unit's operations over its peak."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(tensor_flop / PEAK_BF16_FLOP_S, f32_flop / PEAK_F32_FLOP_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def siren_bounds(k, n, h, n_params, n_freq=0, d=1, weighted=False,
                 fwd_passes=3, grad_passes=2):
    """Bounds of the three SIREN kernels at (k windows, n rows, width h,
    n_params floats a window, n_freq RFF frequencies or 0 for a raw layer
    0 of d columns), 2 sine + 2 snake layers + a linear head: bf16x3
    forward products (``fwd_passes`` bf16 products a MAC; bf16x2: 2),
    bf16x2 backward products (the grad tier, ``grad_passes``; bf16: 1; dW
    of every layer, dgrad of layers 1+), and ~20 fp32 operations for each
    sine / snake activation and RFF feature.  ``weighted``: D and E also
    read a per-row loss weight (C's slot is then E's bound)."""
    rows = k * n
    l0 = (2 * n_freq if n_freq else d) * h
    macs = l0 + 4 * h * h + h                     # per row, forward
    dgrad = 4 * h * h + h                         # per row, below layer 1
    act = 20 * (5 * h + 2 * n_freq)               # per row, activations
    p_bytes = 4 * k * n_params
    stack = bound(p_bytes + 4 * rows * 2, 2 * fwd_passes * macs * rows,
                  act * rows)
    train_flop = (2 * fwd_passes * macs
                  + 2 * grad_passes * (macs + dgrad)) * rows
    # D: params, mu, nu and best read and written, targets (and the
    # weight) read
    per_row = 4 * (2 if weighted else 1)
    step = bound(8 * p_bytes + per_row * rows, train_flop, 2 * act * rows)
    # C: params and the cotangent read, the gradient written (E: the
    # targets and the weight in the cotangent's place)
    bwd = bound(2 * p_bytes + per_row * rows, train_flop, 2 * act * rows)
    return stack, step, bwd


def kan_bounds(n, layers_hidden, n_coef=8, order=3):
    """Bounds of G and H for KAN(layers_hidden) over n rows at bf16x3:
    the products on bf16 tensor cores (3 passes; J = n_coef + 1 values a
    feature), and per (row, input feature) ~300 fp32 operations at order 3
    and J = 9 for silu, the Cox-de-Boor recursion and the hi/lo splits:
    ~10 more for each of the local recursion's further evaluations
    (order (order + 3) / 2 of them) and ~4 for each further value of A."""
    J = 1 + n_coef
    dims = list(zip(layers_hidden[:-1], layers_hidden[1:]))
    macs = sum(i * J * o for i, o in dims)
    dx_macs = sum(i * J * o for i, o in dims[1:])
    feats = sum(i for i, _ in dims)
    p_bytes = 4 * sum(o * i * (J + 2) for i, o in dims)
    ops = 300 + 10 * (order * (order + 3) // 2 - 9) + 4 * (J - 9)
    g = bound(4 * n * (layers_hidden[0] + layers_hidden[-1]) + p_bytes,
              6 * macs * n, ops * feats * n)
    # H reads the saved layer inputs, the cotangent and the weights, and
    # writes the gradients
    h = bound(4 * n * (feats + layers_hidden[-1]) + 2 * p_bytes,
              6 * (macs + dx_macs) * n, 2 * ops * feats * n)
    return g, h


def run_cli_fit(cli_main, phase, wav, tag, arch, steps, extra, fused=True,
                plots=False):
    """The CLI ``fit`` in process (so that its launches are counted), with
    ``--no-plots`` unless ``plots`` (the card's machine may have no
    matplotlib) -> (parameters.json record, checkpoint path); fails unless
    every artefact was written."""
    argv = ["fit", "--device", "cuda", "--arch", arch,
            *(["--fused"] if fused else []),
            *([] if plots else ["--no-plots"]),
            "--filename", wav, "--duration", "7.0", "--total-steps",
            str(steps), "--experiment-path", WORK, "--tag", tag, *extra]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    folder = os.path.join(WORK, tag)
    with open(os.path.join(folder, "parameters.json")) as f:
        rec = json.load(f)
    ckpt = json.loads(buf.getvalue().strip().splitlines()[-1])["ckpt"]
    files = {name: os.path.exists(os.path.join(folder, name))
             for name in ("saved_ckpt.npz", "metrics.jsonl",
                          "parameters.json", "output.wav")}
    log(f"{phase} CLI {' '.join(argv[:6])} {' '.join(extra)} "
        f"--total-steps {steps}: rc={rc} in {wall:.1f} s, "
        f"{rec['steps_per_sec']:.2f} steps/s, best loss "
        f"{rec['best_loss']:.6g} at {rec['best_iter']}, SNR "
        f"{rec['SNR']:.3f} dB, files {files}")
    if rc != 0 or not all(files.values()) or ckpt != \
            os.path.join(folder, "saved_ckpt.npz"):
        raise AssertionError(f"CLI fit {tag} failed")
    return rec, ckpt


def plain_kan_model(kf, model):
    """``model`` with G and H's plain versions on the card, through the
    same autograd Function (the package sends CUDA tensors only to the
    kernels)."""
    return dataclasses.replace(model, apply=lambda p, c: kf.fused_kan_apply(
        p, model.config, c, stack=kf.PLAIN_STACK))


def kan_phases(np, torch, dev, clip):
    """Phases 8-10: kernels G and H against their plain versions at the
    runner shape, the KAN fit served through the entry points, and the
    KAN timings."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import waveform_fitting, write_wav
    from inraudio_tpu_torch.eval.decode import decode_problem
    from inraudio_tpu_torch.eval.metrics import reconstruction_snr
    from inraudio_tpu_torch.models import (KANConfig, build_model, rff_apply,
                                           rff_init)
    from inraudio_tpu_torch.ops import kan_fused as kf
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.checkpoint import load_checkpoint
    from inraudio_tpu_torch.tree import tree_map
    from test_torch_cuda import (KAN_GRAD_RTOL, KAN_RTOL, check_kan,
                                 check_kan_outputs)

    out = {}
    n = CLIP_SAMPLES
    cfg = KANConfig(layers_hidden=KAN_LAYERS)
    model = build_model("kan", cfg, fused=True)
    params = model.init(torch.Generator().manual_seed(SEED), dev)
    flat = [t.detach().contiguous() for t in kf.flatten_kan_params(params)]
    layers = list(zip(flat[0::2], flat[1::2]))
    mode, order = kf.kan_dot_mode(), cfg.spline_order
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    targets = torch.from_numpy(clip / np.max(np.abs(clip)))[:, None].to(dev)

    # ---- phase 8: G and H against their plain versions ----
    gout, xs = kf.KAN_FWD(layers, coords, order, mode)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ref, xr = kf.kan_forward_plain(layers, coords, order, mode)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - base
    out["kan_fwd_err"], fwd_ratio = check_kan_outputs(layers, xs, gout, xr,
                                                      ref, order)
    cot = (2.0 / n) * (ref - targets)
    gk = kf.KAN_BWD(layers, xr, cot, order, mode)
    gp = kf.kan_backward_plain(layers, xr, cot, order, mode)
    torch.cuda.synchronize()
    out["kan_bwd_err"] = max(check_kan(a, b, KAN_GRAD_RTOL)
                             for a, b in zip(gk, gp))
    bwd_ratio = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(gk, gp))
    log(f"phase8 KAN{KAN_LAYERS} over {n} rows, {mode} tier (tolerances: "
        f"each layer output max-abs <= {KAN_RTOL} x its term scale, each "
        f"dW max-abs <= {KAN_GRAD_RTOL} x max |dW|): G max abs "
        f"{out['kan_fwd_err']:.3e} (max |out| {float(ref.abs().max()):.3e}"
        f", largest ratio to a layer's term scale {fwd_ratio:.2e}); H max "
        f"abs {out['kan_bwd_err']:.3e} (largest ratio to max |dW| "
        f"{bwd_ratio:.2e}); the plain "
        f"forward's peak {plain_peak / 2**30:.2f} GiB")
    gout2, xs2 = kf.KAN_FWD(layers, coords, order, mode)
    torch.cuda.synchronize()
    if not (torch.equal(gout, gout2)
            and all(torch.equal(a, b) for a, b in zip(xs, xs2))):
        raise AssertionError("two G calls from one input differ")
    log("phase8 two G calls from one input: bit-equal")
    gk2 = kf.KAN_BWD(layers, xr, cot, order, mode)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
        raise AssertionError("two H calls from one state differ")
    log("phase8 two H calls from one state: bit-equal")
    del gout, xs, gout2, xs2, gk, gk2, gp

    # ---- phase 9: the KAN fit served through the entry points ----
    wav = os.path.join(WORK, "kan_clip.wav")
    write_wav(wav, FS, clip)
    counters = {"siren_stack": sf.SIREN_STACK, "siren_step": ss.SIREN_STEP,
                "siren_bwd": st.SIREN_BWD, "kan_fwd": kf.KAN_FWD,
                "kan_bwd": kf.KAN_BWD}
    duration = 7.0  # the whole clip (308,207 samples < 7 s)

    def cli_fit(tag, extra):
        return run_cli_fit(cli_main, "phase9", wav, tag, "kan",
                           KAN_FIT_STEPS, extra)

    for c in counters.values():
        c.launches = 0
    rec, ckpt = cli_fit("kan_cli", ["--hidden", str(KAN_LAYERS[1])])
    out["kan_fit_steps_s"] = rec["steps_per_sec"]
    problem = waveform_fitting(wav, duration)
    template = tloop.init_train_state(model, torch.Generator(),
                                      tloop.TrainConfig(), dev)
    state = load_checkpoint(ckpt, template)
    rec_wav, rate = decode_problem(model, state.best_params, problem,
                                   device=dev)
    snr = reconstruction_snr(problem.targets[:, 0] * problem.decode["peak"],
                             rec_wav)
    log(f"phase9 checkpoint -> load_checkpoint -> decode_problem on the "
        f"card: {rec_wav.shape[0]} samples at {rate} Hz, SNR {snr:.3f} dB "
        f"(the run's own record {rec['SNR']:.3f} dB)")
    if (rec_wav.shape != clip.shape or not np.isfinite(rec_wav).all()
            or abs(snr - rec["SNR"]) > 1e-3):
        raise AssertionError("the loaded checkpoint decodes differently")
    rff, _ = cli_fit("kan_rff", ["--num-freq", "256", "--sigma", "1500",
                                 "--hidden", "128"])
    out["launches_kan"] = {name: c.launches for name, c in counters.items()}
    log(f"phase9 kernel launches in the served KAN fits: "
        f"{out['launches_kan']}")
    if (out["launches_kan"]["kan_fwd"] < 2 * KAN_FIT_STEPS
            or out["launches_kan"]["kan_bwd"] < 2 * KAN_FIT_STEPS):
        raise AssertionError("the KAN fit did not run through G and H")
    out["kan_rff_snr"] = rff["SNR"]

    # the kernel fit against the plain-version fit from one initial state,
    # beside the kernel fit from the init times (1 + 2^-22).  The RFF
    # recipe's KAN, whose loss moves within a few steps (the raw-coordinate
    # KAN's stays at the signal's power).
    rcfg = KANConfig(layers_hidden=(512, 128, 128, 1))
    rmodel = build_model("kan", rcfg, fused=True)
    pmodel = plain_kan_model(kf, rmodel)
    b = rff_init(torch.Generator().manual_seed(SEED), 1, 256, sigma=1500.0,
                 device=dev)
    feats = rff_apply(b, torch.from_numpy(problem.coords).to(dev))
    tc = tloop.TrainConfig(total_steps=KAN_CMP_STEPS,
                           scan_chunk=KAN_CMP_STEPS)
    x_np, y_np = problem.coords, problem.targets
    r0 = tloop.init_train_state(rmodel, torch.Generator().manual_seed(SEED),
                                tc, dev)

    def fit_from(m, scale=1.0):
        st0 = r0._replace(params=tree_map(lambda t: t * scale, r0.params))
        st0 = tree_map(torch.clone, st0)
        return tloop.fit(m, feats, y_np, tc, state=st0, device=dev)

    kern, plain = fit_from(rmodel), fit_from(pmodel)
    ulp = fit_from(rmodel, 1.0 + 2.0 ** -22)
    lk, lp, lu = (float(r.loss_history[-1]) for r in (kern, plain, ulp))
    limit = max(KAN_CMP_CONTROL_X * abs(lk - lu), KAN_CMP_FLOOR_REL * lk)
    log(f"phase9 KAN(512, 128, 128, 1) on the RFF features, "
        f"{KAN_CMP_STEPS}-step fits from one state: first loss "
        f"{float(kern.loss_history[0]):.9g}; final loss "
        f"kernel {lk:.9g} / plain {lp:.9g} / perturbed kernel {lu:.9g}; "
        f"gated |kernel - plain| {abs(lk - lp):.3e} (limit {limit:.3e} = "
        f"max({KAN_CMP_CONTROL_X} x control {abs(lk - lu):.3e}, "
        f"{KAN_CMP_FLOOR_REL} x loss)); steps/s kernel "
        f"{kern.steps_per_sec:.2f}, plain {plain.steps_per_sec:.2f}")
    if not abs(lk - lp) <= limit:
        raise AssertionError("kernel fit and plain-version fit disagree")

    # ---- phase 10: timings ----
    out["kan_fwd_ms"] = cuda_ms(torch, lambda: kf.KAN_FWD(
        layers, coords, order, mode), 10)
    out["kan_fwd_plain_ms"] = cuda_ms(torch, lambda: kf.kan_forward_plain(
        layers, coords, order, mode), 3)
    out["kan_bwd_ms"] = cuda_ms(torch, lambda: kf.KAN_BWD(
        layers, xr, cot, order, mode), 10)
    out["kan_bwd_plain_ms"] = cuda_ms(torch, lambda: kf.kan_backward_plain(
        layers, xr, cot, order, mode), 3)
    log(f"phase10 G {out['kan_fwd_ms']:.3f} ms (plain "
        f"{out['kan_fwd_plain_ms']:.3f} ms), H {out['kan_bwd_ms']:.3f} ms "
        f"(plain {out['kan_bwd_plain_ms']:.3f} ms)")
    lib = kf.KAN_LIBRARY()
    stream = torch.cuda.current_stream().cuda_stream
    parts, out["kan_parts"] = [], []
    for li, (grid, w_t) in enumerate(layers):
        s = kf._layer_shape(xr[li], grid, w_t, order, li)
        g = torch.ones((n, s.dout), device=dev) / n
        plan = kf.dw_plan(s.n, s.din, s.dout, s.J, mode)
        fplan = kf.fwd_plan(s.din, s.dout, s.J, mode)
        need_dx = li > 0
        t = {"G": cuda_ms(torch, lambda: kf.KAN_FWD(
            [(grid, w_t)], xr[li], order, mode), 5),
             "plain G": cuda_ms(torch, lambda: kf.kan_layer_forward_plain(
                 xr[li], grid, w_t, order, mode), 3)}
        # H's parts: the cotangent's bf16 split (tensor-core route), dW
        # (the pass without dx, less the split and the reduce), dx (what
        # asking for it adds: W's split and, on the tensor-core and narrow
        # routes, its share of the one pass for both) and the fixed-order
        # reduce
        t["g split"] = (cuda_ms(torch, lambda: kf.split_g(
            lib, g, s, plan, stream), 5) if plan.route == "tc" else 0.0)
        partial = torch.zeros((plan.slices, s.dout, s.K), device=dev)
        dw_t = torch.empty((s.dout, s.K), device=dev)
        t["reduce"] = cuda_ms(torch, lambda: lib.kan_reduce(
            partial.data_ptr(), dw_t.data_ptr(), s.dout * s.K, plan.slices,
            1, stream), 5)
        dw_only = cuda_ms(torch, lambda: kf.layer_backward(
            lib, xr[li], grid, g, w_t, s, order, mode, stream, False), 5)
        t["dW"] = dw_only - t["g split"] - t["reduce"]
        if need_dx:
            t["dx"] = cuda_ms(torch, lambda: kf.layer_backward(
                lib, xr[li], grid, g, w_t, s, order, mode, stream, True),
                5) - dw_only
        del partial
        out["kan_parts"].append(((li, s.din, s.dout, fplan.route,
                                  plan.route), t))
        parts.append(f"layer {li} ({s.din}->{s.dout}, G {fplan.route} "
                     f"tile {fplan.tile} fc {fplan.fc}, H {plan.route}): "
                     + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log("phase10 per layer (CUDA events): " + "; ".join(parts))
    del xr, cot, ref
    del feats, kern, plain, ulp, r0
    s0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                tc, dev)
    step_k = tloop.make_train_step(model, tc)
    step_p = tloop.make_train_step(plain_kan_model(kf, model), tc)
    state = tree_map(torch.clone, s0)
    out["kan_step_ms"] = cuda_ms(torch, lambda: step_k(state, coords,
                                                       targets), 5)
    out["kan_step_plain_ms"] = cuda_ms(torch, lambda: step_p(state, coords,
                                                             targets), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = tloop.fit(model, x_np, y_np, dataclasses.replace(
        tc, total_steps=20, scan_chunk=10), state=tree_map(torch.clone, s0),
        device=dev)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase10 whole KAN step: kernels {out['kan_step_ms']:.3f} ms, "
        f"plain {out['kan_step_plain_ms']:.3f} ms; fit 20 steps "
        f"{r.steps_per_sec:.2f} steps/s, peak device memory "
        f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held "
        f"before; CLI fit {out['kan_fit_steps_s']:.2f} steps/s")
    out["kan_bounds"] = kan_bounds(n, KAN_LAYERS)
    return out


def runner_shapes(torch, dev):
    """{"runner_mlp": None, "runner_mlp_rff": B}: the runner's RFF
    projection for seed SEED (RUNNER_NUM_FREQ frequencies at sigma
    RUNNER_SIGMA) on ``dev``."""
    from inraudio_tpu_torch.experiments import runner as trunner
    from inraudio_tpu_torch.models import rff_init
    b = rff_init(
        torch.Generator().manual_seed(trunner._RFF_SEED_OFFSET + SEED), 1,
        RUNNER_NUM_FREQ, sigma=RUNNER_SIGMA, device=dev)
    return {"runner_mlp": None, "runner_mlp_rff": b}


def runner_model(rff_b):
    """The runner's production mlp (fused), raw or owning ``rff_b``."""
    from inraudio_tpu_torch.experiments import runner as trunner
    return trunner.build_arch(
        "mlp", 1 if rff_b is None else 2 * RUNNER_NUM_FREQ, RUNNER_H, 2, 2, 0,
        RUNNER_OMEGA, 30.0, 0.5, fused=True, rff_b=rff_b)


def runner_phases(np, torch, dev, clip):
    """Phases 11-13: the runner's production mlp at full width over the
    whole clip, raw and with RFF: its kernels against their plain versions,
    the fit served through the entry points, and the timings."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import waveform_fitting, write_wav
    from inraudio_tpu_torch.eval.decode import decode_problem
    from inraudio_tpu_torch.eval.metrics import reconstruction_snr
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.checkpoint import load_checkpoint
    from inraudio_tpu_torch.tree import tree_map
    from test_torch_cuda import (BF16_BULK_ATOL, BF16_MAX_ATOL, F32_ATOL,
                                 RFF_PRE_RTOL, TIER_IDS, TIERS,
                                 check_rff_backward, check_rff_steps,
                                 clone_state, is_bf16_tier, perturb_layer0,
                                 stacked)

    wav = os.path.join(WORK, "runner_clip.wav")
    write_wav(wav, FS, clip)
    problem = waveform_fitting(wav, 7.0)
    n = problem.coords.shape[0]
    coords = torch.from_numpy(problem.coords).to(dev)
    targets = torch.from_numpy(problem.targets[:, 0]).to(dev)[None]
    shapes = runner_shapes(torch, dev)
    gmode = st.grad_dot_mode()
    tc = tloop.TrainConfig()  # the runner's defaults: lr 1e-3, no clip
    out, fails, keep = {}, [], {}
    # ---- phase 11: the kernels against their plain versions ----
    for name, rb in shapes.items():
        model = runner_model(rb)
        cfg = model.config
        bt = None if rb is None else sf._prep_rff_bt(rb)
        params = model.init(torch.Generator().manual_seed(SEED), dev)
        sp, pert = stacked(params), perturb_layer0(params)
        errs = []
        for tier, kw in zip(TIER_IDS, TIERS):  # every tier of the gate
            plan = sf.stack_plan(cfg, rff=rb is not None, **kw)
            pre0 = torch.empty((1, n, RUNNER_H), device=dev)
            kout = sf.SIREN_STACK(sp, plan, coords, bt, pre0=pre0)[0]
            ref = sf.stack_forward_plain(params, plan, coords, bt)
            ctrl = sf.stack_forward_plain(pert, plan, coords, bt)
            pre_ref = st.fwd_pres_plain(params, plan, coords, bt)[1][0][1]
            torch.cuda.synchronize()
            err = float((kout - ref).abs().max())
            c = float((ctrl - ref).abs().max())
            pre_err = float((pre0[0] - pre_ref).abs().max())
            pre_scale = float(pre_ref.abs().max())
            floor = BF16_MAX_ATOL if is_bf16_tier(kw) else F32_ATOL
            limit = max(RUNNER_CTRL_X * c, floor)
            bulk = float(((kout - ref).abs() <= BF16_BULK_ATOL).float().mean())
            ok = (bool(torch.isfinite(kout).all()) and err <= limit
                  and pre_err <= RFF_PRE_RTOL * pre_scale)
            errs.append(err)
            route = sf.stack_launch(plan, RUNNER_H, n).route
            log(f"phase11 {name} stack tier={tier} route={route} kwargs={kw}"
                f": output max "
                f"abs {err:.3e} (limit {limit:.3e} = max({RUNNER_CTRL_X} x "
                f"control {c:.3e}, {floor})), {bulk:.4f} of rows within "
                f"{BF16_BULK_ATOL}; layer-0 pre max abs "
                f"{pre_err:.3e} = {pre_err / pre_scale:.2e} of max |pre| "
                f"{pre_scale:.3e} (limit {RFF_PRE_RTOL}); "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                fails.append(f"{name} stack {tier}")
            del pre0, pre_ref, kout
        out[(name, "stack_err")] = max(errs)
        # C for the MSE cotangent of the training forward
        plan = sf.stack_plan(cfg, approx_sin=True, rff=rb is not None)
        fout = sf.stack_forward_plain(params, plan, coords, bt)
        cot = ((2.0 / n) * (fout[:, 0] - targets[0]))[None, :, None]
        cot = cot.contiguous()
        del fout
        try:
            err, c, limit, scale = check_rff_backward(sp, cfg, plan, gmode,
                                                      coords, cot, bt)
            verdict = "ok"
        except AssertionError as e:
            (err, c, limit), scale, verdict = e.args[0], float("nan"), \
                "FAILED"
            fails.append(f"{name} C")
        log(f"phase11 {name} C vs plain ({gmode} grad tier): max abs "
            f"{err:.3e} of max |grad| {scale:.3e} (limit {limit:.3e} = max("
            f"{RUNNER_CTRL_X} x control {c:.3e}, the tier's tolerance)); "
            f"{verdict}")
        out[(name, "bwd_err")] = err
        # D: 3 steps from one state: kernel, plain, and plain from layer 0
        # one ulp off
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(SEED), tc, dev, windows=1)
        try:
            a, gaps = check_rff_steps(cfg, tc, coords, targets, state, rb)
            verdict = "ok"
        except AssertionError as e:
            gaps, verdict = e.args[0] if e.args else {}, "FAILED"
            fails.append(f"{name} D")
        log(f"phase11 {name} D vs plain, 3 steps from one state: {gaps}; "
            f"{verdict}")
        if verdict != "ok":
            continue
        out[(name, "step_err")] = gaps["grad"]
        kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                             rff_b=rb)
        pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                             step_call=ss.step_plain,
                                             rff_b=rb)
        s1, (l1, _) = kstep(clone_state(a), coords, targets)
        s2, (l2, _) = kstep(clone_state(a), coords, targets)
        torch.cuda.synchronize()
        same = torch.equal(l1, l2) and all(torch.equal(x, y)
                                           for x, y in zip(s1, s2))
        if not same:
            fails.append(f"{name} D determinism")
        log(f"phase11 {name} two kernel steps from one state: "
            f"{'bit-equal' if same else 'DIFFER'}")
        keep[name] = dict(model=model, cfg=cfg, bt=bt, params=params, sp=sp,
                          cot=cot, state=a, kstep=kstep, pstep=pstep,
                          plan=plan, rff_b=rb)
        del s1, s2
    if fails:
        raise AssertionError(f"phase 11 failed: {fails}")

    # ---- phase 12: served through the entry points ----
    counters = {"siren_stack": sf.SIREN_STACK, "siren_step": ss.SIREN_STEP,
                "siren_bwd": st.SIREN_BWD}
    for c in counters.values():
        c.launches = 0
    counts = lambda: {k: c.launches for k, c in counters.items()}  # noqa
    delta = lambda c1, c0: {k: c1[k] - c0[k] for k in c1}  # noqa: E731
    served = {}
    c0 = counts()
    rec_raw, _ = run_cli_fit(cli_main, "phase12", wav, "mlp_cli", "mlp",
                             RUNNER_FIT_STEPS, [])
    c1 = counts()
    rec_rff, ck_rff = run_cli_fit(cli_main, "phase12", wav, "mlp_rff_cli",
                                  "mlp", RUNNER_FIT_STEPS,
                                  ["--num-freq", str(RUNNER_NUM_FREQ)])
    c2 = counts()
    served["runner_mlp"], served["runner_mlp_rff"] = delta(c1, c0), \
        delta(c2, c1)
    out["runner_fit_steps_s"] = {"runner_mlp": rec_raw["steps_per_sec"],
                                 "runner_mlp_rff": rec_rff["steps_per_sec"]}
    model = keep["runner_mlp_rff"]["model"]
    template = tloop.init_train_state(model, torch.Generator(),
                                      tloop.TrainConfig(), dev)
    state = load_checkpoint(ck_rff, template)
    sig_pow = float(np.mean(np.square(problem.targets)))
    fit_db = 10.0 * float(np.log10(sig_pow / rec_rff["best_loss"]))
    rec_wav, rate = decode_problem(model, state.best_params, problem,
                                   fit_snr_db=fit_db, device=dev)
    snr = reconstruction_snr(problem.targets[:, 0] * problem.decode["peak"],
                             rec_wav)
    log(f"phase12 RFF checkpoint -> load_checkpoint -> decode_problem on the "
        f"card (tier {sf.auto_decode_kwargs(fit_db, first_omega_0=RUNNER_OMEGA)}"
        f"): {rec_wav.shape[0]} samples at {rate} Hz, SNR {snr:.3f} dB (the "
        f"run's own record {rec_rff['SNR']:.3f} dB)")
    if (rec_wav.shape != clip.shape or not np.isfinite(rec_wav).all()
            or abs(snr - rec_rff["SNR"]) > 1e-3):
        raise AssertionError("the loaded RFF checkpoint decodes differently")
    # the JAX package's route for the RFF model at h=256: autograd over the
    # stack forward and kernel C
    for name in shapes:
        m = keep[name]["model"]
        cb = counts()
        st0 = tloop.init_train_state(m, torch.Generator().manual_seed(SEED),
                                     tc, dev)
        step = tloop.make_train_step(m, tc)
        losses = []
        for _ in range(RUNNER_AUTOGRAD_STEPS):
            st0, (loss, _) = step(st0, coords, targets[0][:, None])
            losses.append(float(loss))
        d = delta(counts(), cb)
        served[name + "_autograd"] = d
        log(f"phase12 {name}: {RUNNER_AUTOGRAD_STEPS} autograd steps "
            f"(train.loop.make_train_step), losses {losses}, launches {d}")
        if not all(np.isfinite(losses)) or \
                d["siren_bwd"] < RUNNER_AUTOGRAD_STEPS:
            raise AssertionError(f"{name}: autograd steps failed")
        del st0
    # the kernel fit against the plain-step fit from one state, beside the
    # kernel fit from the init times (1 + 2^-22)
    pmodel = dataclasses.replace(
        model, fused_step_ctx={**model.fused_step_ctx, "step": ss.step_plain})
    ctc = tloop.TrainConfig(total_steps=RUNNER_CMP_STEPS,
                            scan_chunk=RUNNER_CMP_STEPS)
    r0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                ctc, dev)

    def fit_from(m, scale=1.0):
        st0 = r0._replace(params=tree_map(lambda t: t * scale, r0.params))
        return tloop.fit(m, problem.coords, problem.targets, ctc,
                         state=tree_map(torch.clone, st0), device=dev)

    kern, plain = fit_from(model), fit_from(pmodel)
    ulp = fit_from(model, 1.0 + 2.0 ** -22)
    lk, lp, lu = (float(r.loss_history[-1]) for r in (kern, plain, ulp))
    limit = max(KAN_CMP_CONTROL_X * abs(lk - lu), KAN_CMP_FLOOR_REL * lk)
    log(f"phase12 runner mlp RFF, {RUNNER_CMP_STEPS}-step fits from one "
        f"state: first loss {float(kern.loss_history[0]):.9g}; final loss "
        f"kernel {lk:.9g} / plain {lp:.9g} / perturbed kernel {lu:.9g}; "
        f"gated |kernel - plain| {abs(lk - lp):.3e} (limit {limit:.3e} = "
        f"max({KAN_CMP_CONTROL_X} x control {abs(lk - lu):.3e}, "
        f"{KAN_CMP_FLOOR_REL} x loss)); steps/s kernel "
        f"{kern.steps_per_sec:.2f}, plain {plain.steps_per_sec:.2f}")
    if not abs(lk - lp) <= limit:
        raise AssertionError("runner kernel fit and plain-step fit disagree")
    del kern, plain, ulp, r0
    out["launches_runner"] = counts()
    out["served"] = served
    log(f"phase12 kernel launches in the served runner paths: {served}; "
        f"total {out['launches_runner']}")
    for name in shapes:
        if (served[name]["siren_step"] < RUNNER_FIT_STEPS
                or served[name]["siren_stack"] < 1):
            raise AssertionError(f"the {name} fit did not run through D "
                                 "and the stack kernel")

    # ---- phase 13: timings ----
    for name, kp in keep.items():
        cfg, bt, plan, sp = kp["cfg"], kp["bt"], kp["plan"], kp["sp"]
        state = kp["state"]
        n_freq = 0 if bt is None else bt.shape[1]
        t = {}
        t["stack"] = cuda_ms(torch, lambda: sf.SIREN_STACK(sp, plan, coords,
                                                           bt), 10)
        t["stack_plain"] = cuda_ms(torch, lambda: sf.stack_forward_plain(
            kp["params"], plan, coords, bt), 3)
        t["bwd"] = cuda_ms(torch, lambda: st.SIREN_BWD(
            sp, cfg, plan, gmode, coords, kp["cot"], bt), 5)
        t["bwd_plain"] = cuda_ms(torch, lambda: st.backward_plain(
            sp, plan, gmode, coords, kp["cot"], bt), 2)
        t["step"] = cuda_ms(torch, lambda: kp["kstep"](state, coords,
                                                       targets), 10)
        t["step_plain"] = cuda_ms(torch, lambda: kp["pstep"](state, coords,
                                                             targets), 2)
        # one step's split: the grad accumulation's kernels and the reduce
        # timed apart (tc_split_ms), then clip + Adam + best on their output
        lib = st.TRAIN_LIBRARY()
        g = st.validate_grad_launch(state.params, cfg, plan, coords, bt)
        tp = st.tc_plan(g, gmode)
        stream = torch.cuda.current_stream().cuda_stream
        P = g.layout.size
        split = tc_split_ms(torch, st, g, coords, state.params, 10,
                            targets=targets, gmode=gmode)
        grads, sq_part, loss_part = st.grad_reduce(
            lib, g, coords, state.params, stream, targets=targets,
            gmode=gmode)
        loss, scale = (torch.empty((1,), device=dev) for _ in range(2))
        tf = (state.step + 1).to(torch.float32)
        c1_, c2_ = 1.0 - 0.9 ** tf, 1.0 - 0.999 ** tf
        # device time: at k = 1 the epilogue is microseconds, below the
        # host time of its launches
        t["adam"] = device_ms(torch, lambda: ss.launch_adam(
            lib, grads, sq_part, loss_part, state.params, state.mu, state.nu,
            state.best_params, loss, scale, state.lr, c1_, c2_,
            state.best_loss, tc.grad_clip_norm, stream), F_ITERS)[0]
        del grads, sq_part, loss_part
        t["split"] = split
        t["grad"] = (split["siren_wsplit"] + split["siren_sweep"]
                     + split["siren_dw"])
        t["reduce"] = split["siren_reduce"]
        parts = t["grad"] + t["reduce"] + t["adam"]
        route = sf.stack_launch(plan, RUNNER_H, n).route
        log(f"phase13 {name}: stack kernel ({route} route) "
            f"{t['stack']:.3f} ms (plain "
            f"{t['stack_plain']:.3f}), C {t['bwd']:.3f} ms (plain "
            f"{t['bwd_plain']:.3f}), whole step {t['step']:.3f} ms (plain "
            f"{t['step_plain']:.3f}); one step's split: grad accumulation "
            f"{t['grad']:.3f} ms over {g.tiles} row tiles in {tp.slices} "
            f"slices, {len(st.tc_passes(tp.slices, tp.units))} pass(es) "
            f"(weight split {split['siren_wsplit']:.3f}, sweep "
            f"{split['siren_sweep']:.3f}, dW {split['siren_dw']:.3f}), "
            f"reduce {t['reduce']:.3f} ms, clip + Adam + best "
            f"{t['adam']:.3f} ms, plateau / best bookkeeping and launch gaps "
            f"{t['step'] - parts:.3f} ms (the step minus the parts)")
        log(f"phase13 {name} {tc_bytes_line(st, g, gmode)}")
        # the fit's rate and peak memory against the scratch bound
        s0 = tloop.init_train_state(kp["model"],
                                    torch.Generator().manual_seed(SEED), tc,
                                    dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = tloop.fit(kp["model"], problem.coords, problem.targets,
                      dataclasses.replace(tc, total_steps=20, scan_chunk=10),
                      state=s0, device=dev)
        peak = torch.cuda.max_memory_allocated() - base
        group, pass_ = tp.scratch_bytes(P, len(plan.kinds))
        allowed = (st.SCRATCH_BYTES + st.PLANE_BYTES + 4 * 8 * P
                   + 4 * 16 * n)
        log(f"phase13 {name} fit 20 steps: {r.steps_per_sec:.2f} steps/s; "
            f"peak device memory {peak / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB held before (grad scratch: slabs and "
            f"weight planes {group / 2**20:.1f} MiB = {tp.slices} slices x "
            f"P={P} floats + 2 x {tp.wq} bf16, planes and pres of a pass "
            f"{pass_ / 2**20:.1f} MiB = {tp.units} units x ({tp.unit_elems} "
            f"bf16 + {len(plan.kinds)} x {tp.group * 8192} floats); limit "
            f"{allowed / 2**20:.1f} MiB = SCRATCH_BYTES "
            f"{st.SCRATCH_BYTES / 2**20:.0f} MiB + PLANE_BYTES "
            f"{st.PLANE_BYTES / 2**20:.0f} MiB + 8 state-sized groups + 16 "
            f"floats a row)")
        if peak > allowed:
            raise AssertionError(f"{name}: the fit's peak memory exceeds the "
                                 "scratch bound")
        n_params = sum(v.numel() for p in kp["params"]["layers"]
                       for v in p.values())
        t["bounds"] = siren_bounds(1, n, RUNNER_H, n_params, n_freq)
        t["fit_steps_s"] = r.steps_per_sec
        t["peak_mib"] = peak / 2**20
        out[name] = t
        del s0, r
    return out


def _shard_inputs(torch, np, dev, coords, targets, rank, size, block,
                  weight=None):
    """(coords, targets (1, rows), int32 limit, RowShard) of one rank's
    rows, as the row-sharded fit lays them out; with a per-row ``weight``
    also the rank's weight (1, rows), normalised over the clip."""
    from inraudio_tpu_torch.parallel import Mesh, shard_problem_arrays
    cs, ts, ws, sh = shard_problem_arrays(Mesh(None, rank, size, dev),
                                          coords, targets, block,
                                          weight=weight)
    limit = torch.tensor([sh.valid], dtype=torch.int32, device=dev)
    if weight is None:
        return cs, ts.reshape(1, -1), limit, sh
    return cs, ts.reshape(1, -1), limit, sh, ws.reshape(1, -1)


def shard_phases(np, torch, dev, clip):
    """Phases 14-16: kernels E and F at the runner mlp shapes against their
    plain versions; the row-sharded fits (raw, RFF, the KAN's autograd
    step), the window-sharded headline encode and the ``torchrun`` CLI,
    served on two ranks that share the card; and their timings."""
    from inraudio_tpu_torch.data import waveform_fitting
    from inraudio_tpu_torch.models import KANConfig, build_model
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    multi_inr_fit)
    from inraudio_tpu_torch.tree import tree_leaves, tree_map
    from test_torch_cuda import (ADAM_RTOL, GRAD_BF16_MAX_RTOL, GRAD_F32_RTOL,
                                 LOSS_RTOL, clone_state, is_bf16_grad,
                                 perturb_layer0, run_thread_ranks)

    wav = os.path.join(WORK, "runner_clip.wav")
    problem = waveform_fitting(wav, 7.0)
    x, y = problem.coords, problem.targets
    n = x.shape[0]
    coords = torch.from_numpy(x).to(dev)
    targets = torch.from_numpy(y[:, 0]).to(dev)[None]
    shapes = runner_shapes(torch, dev)
    gmode = st.grad_dot_mode()
    tol = GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode) else GRAD_F32_RTOL
    block = st.tile_rows(RUNNER_H)
    tc = tloop.TrainConfig()  # the runner's defaults: lr 1e-3, no clip
    out, fails, keep = {}, [], {}

    # ---- phase 14: E and F against their plain versions ----
    for name, rb in shapes.items():
        model = runner_model(rb)
        cfg = model.config
        bt = None if rb is None else sf._prep_rff_bt(rb)
        plan = sf.stack_plan(cfg, approx_sin=True, rff=rb is not None)
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(SEED), tc, dev, windows=1)
        fs = ss.flat_state_from_train_state(state, cfg)
        fs, _ = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                             rff_b=rb)(fs, coords, targets)
        P = fs.params.shape[1]
        pert = st.flatten_params(perturb_layer0(st.unflatten_params(
            fs.params, cfg)), cfg)
        total, errs, ctls = 0, [], []
        for r in range(2):
            cs, ts, limit, sh = _shard_inputs(torch, np, dev, x, y, r, 2,
                                              block)
            args = (cs, ts, limit, n, cfg, plan, gmode, bt)
            kb = ss.SIREN_GRAD(fs.params, *args)
            again = ss.SIREN_GRAD(fs.params, *args)
            pb = ss.grad_plain(fs.params, *args)
            cb = ss.grad_plain(pert, *args)
            empty = ss.SIREN_GRAD(fs.params, cs, ts, torch.zeros_like(limit),
                                  *args[3:])
            torch.cuda.synchronize()
            scale = float(pb[:P].abs().max())
            err, ctl = float((kb - pb)[:P].abs().max()), \
                float((cb - pb)[:P].abs().max())
            lerr = abs(float(kb[P] - pb[P])) / float(pb[P])
            lctl = abs(float(cb[P] - pb[P])) / float(pb[P])
            limit_g = max(RUNNER_CTRL_X * ctl, tol * scale)
            ok = (bool(torch.isfinite(kb).all()) and err <= limit_g
                  and lerr <= max(RUNNER_CTRL_X * lctl, LOSS_RTOL)
                  and torch.equal(kb, again) and not empty.any())
            log(f"phase14 {name} E shard {r} (rows [{sh.start}, "
                f"{sh.start + sh.rows}), {sh.valid} valid, 1/n_valid of "
                f"{n}): grads max abs {err:.3e} of max |grad| {scale:.3e} "
                f"(limit {limit_g:.3e} = max({RUNNER_CTRL_X} x control "
                f"{ctl:.3e}, {tol} x max)); loss rel {lerr:.2e} (control "
                f"{lctl:.2e}); repeat call bit-equal "
                f"{torch.equal(kb, again)}; limit 0 gives zeros "
                f"{not empty.any()}; {'ok' if ok else 'FAILED'}")
            if not ok:
                fails.append(f"{name} E shard {r}")
            errs.append(err)
            ctls.append(ctl)
            total = total + kb
            del pb, cb, again, empty
        # the shards' sum (what the all-reduce forms) against D's grad
        # accumulation over the whole clip
        g = st.validate_grad_launch(fs.params, cfg, plan, coords, bt)
        grads, _, loss_part = st.grad_reduce(
            st.TRAIN_LIBRARY(), g, coords, fs.params,
            torch.cuda.current_stream().cuda_stream, targets=targets,
            gmode=gmode)
        torch.cuda.synchronize()
        scale = float(grads.abs().max())
        gap = float((total[None, :P] - grads).abs().max())
        lgap = abs(float(total[P] - loss_part.sum())) / float(total[P])
        limit_s = max(RUNNER_CTRL_X * max(ctls), GRAD_F32_RTOL * scale)
        ok = gap <= limit_s and lgap <= LOSS_RTOL
        log(f"phase14 {name} shard 0 + shard 1 against D's grad "
            f"accumulation over all {n} rows: grads max abs {gap:.3e} = "
            f"{gap / scale:.2e} of max |grad| (limit {limit_s:.3e}), loss "
            f"rel {lgap:.2e} (limit {LOSS_RTOL}); {'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"{name} E sum")
        # F on the all-reduced buffer, against adam_epilogue_plain
        t = (fs.step + 1).to(torch.float32)
        c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        ferr = 0.0
        for track_best in (True, False):
            for clip_norm in (0.0, 1.0):
                a, p = clone_state(fs), clone_state(fs)
                la = ss.SIREN_ADAM(a.params, a.mu, a.nu,
                                   a.best_params if track_best else None,
                                   total, a.lr, c1, c2, a.best_loss,
                                   clip_norm)
                ss.adam_epilogue_plain(
                    p.params, p.mu, p.nu,
                    p.best_params if track_best else None,
                    total[:P].view(1, P), p.lr, c1, c2, total[P:P + 1],
                    p.best_loss, clip_norm)
                torch.cuda.synchronize()
                gaps = {k: float((getattr(a, k) - getattr(p, k)).abs().max())
                        for k in ("params", "mu", "nu", "best_params")}
                ok = all(gaps[k] <= ADAM_RTOL * float(getattr(p, k).abs()
                                                      .max()) for k in gaps)
                ok = ok and float(la) == float(total[P])
                exact = all(v == 0.0 for v in gaps.values())
                ferr = max(ferr, gaps["params"])
                log(f"phase14 {name} F (best {track_best}, clip {clip_norm}, "
                    f"loss {float(total[P]):.6g} vs best "
                    f"{float(fs.best_loss):.6g}"
                    f"): max abs " + ", ".join(f"{k} {v:.3e}"
                                               for k, v in gaps.items())
                    + f" (limit {ADAM_RTOL} x each group's max; bit-equal "
                    f"{exact}); {'ok' if ok else 'FAILED'}")
                if not ok:
                    fails.append(f"{name} F best={track_best} "
                                 f"clip={clip_norm}")
        out[(name, "grad_err")] = max(errs)
        out[(name, "adam_err")] = ferr
        keep[name] = dict(model=model, cfg=cfg, bt=bt, plan=plan, fs=fs,
                          total=total, c1=c1, c2=c2, P=P)
        del grads, loss_part
    if fails:
        raise AssertionError(f"phase 14 failed: {fails}")

    # ---- phase 15: served on two ranks sharing the card ----
    counters = launch_counters()

    def served(fn):
        """fn() with every launch count set to 0 before and read after."""
        for c in counters.values():
            c.launches = 0
        res = fn()
        return res, {k: c.launches for k, c in counters.items()}

    def ranks_equal(results, get):
        return all(torch.equal(p, q) for r in results[1:]
                   for p, q in zip(tree_leaves(get(results[0])),
                                   tree_leaves(get(r))))

    stc = tloop.TrainConfig(total_steps=RUNNER_SHARD_STEPS,
                            scan_chunk=RUNNER_SHARD_STEPS)
    # where the machine has several cards, the same fits on min(cards, 4)
    # ranks, one card each (NCCL), under torchrun; held below against the
    # same one-rank fits as the two ranks sharing the card
    cards = torch.cuda.device_count()
    nccl = sharded_fits_torchrun(min(cards, 4)) if cards >= 2 else None
    if nccl is None:
        log(f"phase15 NCCL over several cards: not run ({cards} card)")

    def check_fit(name, label, nranks, one, ulp, r):
        """A sharded fit's record ``r`` (first and final loss, ranks
        bit-equal, launches, steps/s) against the one-rank fit and its
        1-ulp control."""
        l1, lk, lu = (float(one.loss_history[0]),
                      float(one.loss_history[-1]),
                      float(ulp.loss_history[-1]))
        l1s, ls, cnt = r["first"], r["final"], r["launches"]
        limit = max(KAN_CMP_CONTROL_X * abs(lk - lu), KAN_CMP_FLOOR_REL * lk)
        ok = (abs(l1s - l1) <= LOSS_RTOL * l1 and abs(ls - lk) <= limit
              and r["ranks_equal"] and cnt["siren_step"] == 0
              and cnt["siren_grad"] == nranks * RUNNER_SHARD_STEPS
              and cnt["siren_adam"] == nranks * RUNNER_SHARD_STEPS)
        log(f"phase15 {name} fit(mesh={label}), {RUNNER_SHARD_STEPS} steps: "
            f"first loss {l1s:.9g} vs one rank {l1:.9g} (rel "
            f"{abs(l1s - l1) / l1:.2e}, limit {LOSS_RTOL}); final loss "
            f"sharded {ls:.9g} / one rank {lk:.9g} / perturbed one rank "
            f"{lu:.9g}, gated |sharded - one| {abs(ls - lk):.3e} (limit "
            f"{limit:.3e}); ranks bit-equal {r['ranks_equal']}; launches "
            f"{cnt}; steps/s sharded {r['steps_s']:.2f} "
            f"({1e3 / r['steps_s']:.3f} ms a step), one rank "
            f"{one.steps_per_sec:.2f} ({1e3 / one.steps_per_sec:.3f} ms); "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"{name} sharded fit ({label})")

    launches = {}
    for name in shapes:
        model = keep[name]["model"]
        s0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                    stc, dev)
        one = tloop.fit(model, x, y, stc, state=s0, device=dev)
        ulp = tloop.fit(model, x, y, stc, device=dev, state=s0._replace(
            params=tree_map(lambda t: t * (1.0 + 2.0 ** -22), s0.params)))
        res, cnt = served(lambda: run_thread_ranks(2, lambda m: tloop.fit(
            model, x, y, stc, state=s0, mesh=m), device=dev))
        launches[name] = cnt
        check_fit(name, "2 ranks on one card, gloo", 2, one, ulp, dict(
            first=float(res[0].loss_history[0]),
            final=float(res[0].loss_history[-1]),
            ranks_equal=ranks_equal(res, lambda r: r.state)
            and np.array_equal(res[0].loss_history, res[1].loss_history),
            launches=cnt, steps_s=res[0].steps_per_sec))
        if nccl is not None:
            check_fit(name, f"{nccl['size']} cards, {nccl['backend']}",
                      nccl["size"], one, ulp, nccl[name])
        keep[name].update(steps_s=res[0].steps_per_sec,
                          one_steps_s=one.steps_per_sec)
        del one, ulp, res
    # the KAN: the autograd step on each shard (G and H), the gradients
    # all-reduced
    kmodel = build_model("kan", KANConfig(layers_hidden=KAN_LAYERS),
                         fused=True)
    ktc = tloop.TrainConfig(total_steps=KAN_SHARD_STEPS,
                            scan_chunk=KAN_SHARD_STEPS)
    ks0 = tloop.init_train_state(kmodel, torch.Generator().manual_seed(SEED),
                                 ktc, dev)
    kone = tloop.fit(kmodel, x, y, ktc, state=ks0, device=dev)
    kres, cnt = served(lambda: run_thread_ranks(2, lambda m: tloop.fit(
        kmodel, x, y, ktc, state=ks0, mesh=m), device=dev))
    launches["runner_kan"] = cnt
    l1, l1s = float(kone.loss_history[0]), float(kres[0].loss_history[0])
    same = ranks_equal(kres, lambda r: r.state)
    ok = (abs(l1s - l1) <= LOSS_RTOL * l1 and same
          and cnt["kan_fwd"] == 2 * KAN_SHARD_STEPS
          and cnt["kan_bwd"] == 2 * KAN_SHARD_STEPS)
    log(f"phase15 runner KAN{KAN_LAYERS} fit(mesh=2 ranks), "
        f"{KAN_SHARD_STEPS} autograd steps: losses "
        f"{[float(v) for v in kres[0].loss_history]}"
        f" vs one rank {[float(v) for v in kone.loss_history]} (first rel "
        f"{abs(l1s - l1) / l1:.2e}, limit {LOSS_RTOL}); ranks bit-equal "
        f"{same}; launches {cnt}; {'ok' if ok else 'FAILED'}")
    if not ok:
        fails.append("KAN sharded fit")
    del kone, kres
    # the headline encode, its windows sharded over two ranks
    spec = SHAPES["headline"]
    _, hmodel, _, _, _ = train_population(np, torch, dev, clip, "headline",
                                          spec)
    mcfg = MultiINRConfig(chunk_seconds=spec["chunk_seconds"],
                          overlap_fraction=spec["overlap"])
    etc = tloop.TrainConfig(total_steps=ENCODE_SHARD_STEPS,
                            **TRAIN["headline"])
    eone = multi_inr_fit(hmodel, clip, FS, mcfg, etc, seed=SEED, device=dev)
    eres, cnt = served(lambda: run_thread_ranks(2, lambda m: multi_inr_fit(
        hmodel, clip, FS, mcfg, etc, seed=SEED, mesh=m), device=dev))
    launches["headline_encode"] = cnt
    same = all(np.array_equal(r.loss_history, eone.loss_history)
               for r in eres)
    ok = (same and eres[0].num_chunks == spec["expect"][2]
          and cnt["siren_step"] == 2 * ENCODE_SHARD_STEPS
          and ranks_equal(eres, lambda r: r.states))
    log(f"phase15 headline encode, {eres[0].num_chunks} windows on 2 ranks, "
        f"{ENCODE_SHARD_STEPS} steps: every window's loss history bit-equal "
        f"to one rank's {same}; fit {eres[0].train_time_s:.3f} s vs one rank "
        f"{eone.train_time_s:.3f} s; launches {cnt}; "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fails.append("headline window-sharded encode")
    del eone, eres
    out["launches"] = launches
    # the CLI under torchrun, two ranks sharing the card (gloo)
    tag = "mlp_torchrun"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "inraudio_tpu_torch", "fit",
         "--device", "cuda", "--arch", "mlp", "--fused", "--no-plots",
         "--filename", wav, "--duration", "7.0", "--total-steps",
         str(TORCHRUN_STEPS),
         "--experiment-path", WORK, "--tag", tag],
        cwd=HERE, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
    wall = time.perf_counter() - t0
    folder = os.path.join(WORK, tag)
    rec = {}
    if os.path.exists(os.path.join(folder, "parameters.json")):
        with open(os.path.join(folder, "parameters.json")) as f:
            rec = json.load(f)
    ok = (proc.returncode == 0 and "backend gloo" in proc.stderr
          and proc.stdout.count('"ckpt"') == 1
          and all(os.path.exists(os.path.join(folder, f))
                  for f in ("output.wav", "saved_ckpt.npz"))
          and np.isfinite(rec.get("best_loss", np.nan)))
    log(f"phase15 torchrun --nproc-per-node 2 fit --device cuda --arch mlp "
        f"--fused --total-steps {TORCHRUN_STEPS} (2 ranks on one card, "
        f"gloo): rc={proc.returncode} in {wall:.1f} s, "
        f"{rec.get('steps_per_sec', float('nan')):.2f} steps/s, best loss "
        f"{rec.get('best_loss', float('nan')):.6g}; "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        log(proc.stderr[-3000:])
        fails.append("torchrun CLI")
    if fails:
        raise AssertionError(f"phase 15 failed: {fails}")

    # ---- phase 16: timings ----
    for name, kp in keep.items():
        cfg, plan, bt, fs, P = (kp[k] for k in ("cfg", "plan", "bt", "fs",
                                                 "P"))
        cs, ts, limit, sh = _shard_inputs(torch, np, dev, x, y, 0, 2, block)
        args = (cs, ts, limit, n, cfg, plan, gmode, bt)
        t = {}
        t["grad"] = cuda_ms(torch, lambda: ss.SIREN_GRAD(fs.params, *args),
                            10)
        t["grad_plain"] = cuda_ms(torch, lambda: ss.grad_plain(
            fs.params, *args), 3)
        gs = st.validate_grad_launch(fs.params, cfg, plan, cs, bt)
        buf = torch.zeros(P + 4, device=dev)
        t["split"] = tc_split_ms(torch, st, gs, cs, fs.params, 10,
                                 targets=ts, gmode=gmode, limit=limit,
                                 n_valid=n, grads=buf[:P].view(1, P),
                                 loss_out=buf[P:P + 1])
        log(f"phase16 {name} E shard 0: weight split "
            f"{t['split']['siren_wsplit']:.3f} ms, sweep "
            f"{t['split']['siren_sweep']:.3f} ms, dW "
            f"{t['split']['siren_dw']:.3f} ms, reduce "
            f"{t['split']['siren_reduce']:.3f} ms; "
            f"{tc_bytes_line(st, gs, gmode)}")
        # F: its device time from raw entry launches (no Python checks),
        # hot and with the L2 flushed between launches, at clip 0 (the
        # runner's) and 1.0; the wrapper's host time apart; the library
        # call's device time the same two ways
        a = clone_state(fs)
        tot, c1, c2 = kp["total"], kp["c1"], kp["c2"]
        lib = st.TRAIN_LIBRARY()
        stream = torch.cuda.current_stream().cuda_stream
        flush_buf = torch.empty(FLUSH_BYTES // 4, device=dev)
        flush = lambda: flush_buf.add_(1.0)  # noqa: E731
        floss = torch.empty((1,), device=dev)
        fsq = torch.empty((-(-P // st.CHUNK_FLOATS),), device=dev)
        fdev, queued = {}, []
        for clip_norm in (0.0, 1.0):
            args = ss.adam_global_args(
                lib, a.params, a.mu, a.nu, a.best_params, tot, a.lr, c1, c2,
                a.best_loss, floss, fsq, clip_norm, stream)

            def raw(args=args):
                if lib.siren_adam_global(*args) != 0:
                    raise RuntimeError("siren_adam_global launch failed")

            for label, fl in (("hot", None), ("flushed", flush)):
                fdev[(clip_norm, label)], q = device_ms(torch, raw, F_ITERS,
                                                        fl)
                queued.append(q)
        t["adam"] = fdev[(0.0, "hot")]
        t["adam_dev"] = {f"clip{c}_{label}": v
                         for (c, label), v in fdev.items()}
        t["adam_grid"] = args[12]
        t["adam_host"] = host_ms(torch, lambda: ss.SIREN_ADAM(
            a.params, a.mu, a.nu, a.best_params, tot, a.lr, c1, c2,
            a.best_loss, 0.0), F_ITERS)
        t["adam_plain"] = cuda_ms(torch, lambda: ss.adam_epilogue_plain(
            a.params, a.mu, a.nu, a.best_params, tot[:P].view(1, P), a.lr,
            c1, c2, tot[P:P + 1], a.best_loss, 0.0), 20)
        p = torch.zeros(P, device=dev, requires_grad=True)
        p.grad = tot[:P].clone()
        opt = torch.optim.Adam([p], lr=1e-3, fused=True)
        t["adam_library"], q1 = device_ms(torch, opt.step, F_ITERS)
        t["adam_library_flushed"], q2 = device_ms(torch, opt.step, F_ITERS,
                                                  flush)
        t["adam_library_host"] = host_ms(torch, opt.step, F_ITERS)
        queued += [q1, q2]
        t["adam_queued"] = all(queued)
        del p, opt, flush_buf

        def allreduce(m, buf_len=P + 4, reps=20):
            buf = torch.ones(buf_len, device=dev)
            for _ in range(3):
                m.all_reduce_(buf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                m.all_reduce_(buf)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / reps

        t["allreduce"] = run_thread_ranks(2, allreduce, device=dev)[0]
        t["step"] = 1e3 / kp["steps_s"]
        t["one_step"] = 1e3 / kp["one_steps_s"]
        n_params = sum(v[0].numel() for layer in st.unflatten_params(
            fs.params, cfg)["layers"] for v in layer.values())
        n_freq = 0 if bt is None else bt.shape[1]
        t["grad_bound"] = siren_bounds(1, sh.rows, RUNNER_H, n_params,
                                       n_freq)[2]
        # F: g, p, mu, nu read and p, mu, nu written, and best (the old p)
        # only where this loss improves on best_loss; ~12 fp32 operations an
        # element
        improved = float(tot[P]) < float(a.best_loss)
        t["adam_bound"] = bound(4 * (7 + improved) * P, 0, 12 * P)
        fb = t["adam_bound"][0]
        log(f"phase16 {name} F (siren_adam_global_kernel, one cooperative "
            f"launch of {t['adam_grid']} CTAs over {-(-P // st.CHUNK_FLOATS)}"
            f" chunks of {P} floats), device time from {F_ITERS} raw entry "
            f"launches queued behind a sleep: " + ", ".join(
                f"{key} {v:.4f} ms ({100 * fb / v:.1f}% of the bound)"
                for key, v in t["adam_dev"].items())
            + f"; bound {fb:.4f} ms ({t['adam_bound'][1]}, best written "
            f"{improved}); SIREN_ADAM's host time {t['adam_host']:.4f} ms a "
            f"call; torch.optim.Adam(fused=True).step() on one {P}-float "
            f"tensor (no clip, no best): device hot "
            f"{t['adam_library']:.4f} ms, flushed "
            f"{t['adam_library_flushed']:.4f} ms, host "
            f"{t['adam_library_host']:.4f} ms a call; every run queued "
            f"before the device reached it {t['adam_queued']}")
        log(f"phase16 {name}: E per shard ({sh.rows} rows) "
            f"{t['grad']:.3f} ms (plain {t['grad_plain']:.3f}, bound "
            f"{t['grad_bound'][0]:.3f} ms, {t['grad_bound'][1]}); gloo "
            f"all-reduce of {4 * (P + 4) / 1e6:.2f} MB through host memory "
            f"{t['allreduce']:.3f} ms (host clock); F {t['adam']:.4f} ms "
            f"(plain {t['adam_plain']:.4f}); whole sharded step "
            f"{t['step']:.3f} ms ({kp['steps_s']:.2f} steps/s, 2 ranks on "
            f"one card) vs the one-rank D step {t['one_step']:.3f} ms "
            f"({kp['one_steps_s']:.2f} steps/s)")
        out[name] = t
    return out


def launch_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from inraudio_tpu_torch.ops import kan_fused as kf
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    return {"siren_stack": sf.SIREN_STACK, "siren_step": ss.SIREN_STEP,
            "siren_bwd": st.SIREN_BWD, "siren_grad": ss.SIREN_GRAD,
            "siren_adam": ss.SIREN_ADAM, "kan_fwd": kf.KAN_FWD,
            "kan_bwd": kf.KAN_BWD}


def width_phases(np, torch, dev, clip):
    """Phase 17: the rate points at h = 36, 40 and 48, run zero-padded to
    the kernel width 64 with the model's own width passed to the training
    kernels: codec.encode(fused=True) through D (and C for the refit), the
    payload decoded on the card through the stack kernel and held against
    the plain version's decode, launch counts read around each; C against
    its plain backward on the refit's inputs at WIDTH_C_H; then D against
    its plain step from one padded flat state, and D alone from it, whose
    padded slots must stay bit-zero."""
    from inraudio_tpu_torch import codec
    from inraudio_tpu_torch.data import get_coord
    from inraudio_tpu_torch.dsp import calculate_snr
    from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    chunk_signal)
    from test_torch_cuda import (check_close, check_grads, check_state,
                                 padded_slots, steps_kernel_vs_plain)

    counters = launch_counters()
    gmode = st.grad_dot_mode()
    out = {"launches": {}, "snr": {}}
    fails = []

    def gate(name, check, *args):
        """check(*args) -> its max abs difference; an AssertionError is a
        failure of ``name``."""
        try:
            return check(*args)
        except AssertionError as e:
            log(f"phase17 {name}: FAILED {e}")
            fails.append(name)
            return float("nan")

    chunks, n, _ = chunk_signal(clip, FS, MultiINRConfig(
        chunk_seconds=0.5, overlap_fraction=codec.CodecConfig(
            ).overlap_fraction))
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    targets = torch.from_numpy(chunks / scales[:, None]).to(dev)
    coords = torch.from_numpy(get_coord(n, dim=1)).to(dev)
    for h, quant, refit in WIDTH_POINTS:
        name = f"h{h}-{quant}" + (f"-refit{refit}" if refit else "")
        ccfg = codec.CodecConfig(chunk_seconds=0.5, hidden_features=h,
                                 quantize=quant, refit_steps=refit,
                                 total_steps=WIDTH_STEPS, fused=True,
                                 seed=SEED)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        payload = codec.encode(clip, FS, ccfg, device=dev)
        enc_s = time.perf_counter() - t0
        enc = {k: c.launches for k, c in counters.items() if c.launches}
        counters["siren_stack"].launches = 0
        _, rec = codec.decode(payload, dev)
        dec = counters["siren_stack"].launches
        _, ref = codec.decode(payload, "cpu", fused=True)  # plain version
        meta = payload["meta"]
        cfg = codec._model_cfg_from_meta(meta)
        kw = sf.auto_decode_kwargs(codec._routing_fit_snr(meta),
                                   first_omega_0=cfg.first_omega_0)
        err = gate(f"{name} decode", check_close, torch.from_numpy(rec),
                   torch.from_numpy(ref), kw)
        snr_k = float(calculate_snr(clip, rec))
        snr_p = float(calculate_snr(clip, ref))
        out["launches"][name] = {**enc, "decode siren_stack": dec}
        out["snr"][name] = (snr_k, snr_p)
        log(f"phase17 {name}: encode {WIDTH_STEPS} steps in {enc_s:.2f} s, "
            f"k={meta['num_chunks']} windows of {meta['chunk_length']}, "
            f"launches {enc}; decode on the card ({dec} stack launches, "
            f"tier {kw}) max |kernel - plain| {err:.3e} (phase 1's limit "
            f"for the tier), SNR {snr_k:.4f} dB, plain version {snr_p:.4f} "
            f"dB (limit |diff| <= {WIDTH_SNR_DB} dB)")
        if (enc.get("siren_step", 0) < WIDTH_STEPS
                or enc.get("siren_bwd", 0) < refit or dec < 1
                or rec.shape != clip.shape or not np.isfinite(rec).all()
                or abs(snr_k - snr_p) > WIDTH_SNR_DB):
            fails.append(name)
        if not (refit and h == WIDTH_C_H):
            continue
        # C on the refit's inputs: its params (the payload's, dequantized
        # and padded to the kernel width, as the refit pads them), its
        # coords and the gradient of its MSE loss
        params = sf.pad_params(codec.dequantize_inr_params(
            payload["params"], dev), sf.kernel_width(h))
        model = build_model("mlp", cfg, fused=True, approx_sin=True)
        k = meta["num_chunks"]
        cot = (2.0 / (k * n)) * (model.apply(params, coords)
                                 - targets[..., None])
        plan = sf.stack_plan(cfg, approx_sin=True)
        gk = st.flatten_params(st.SIREN_BWD(params, cfg, plan, gmode, coords,
                                            cot), cfg)
        gp = st.flatten_params(st.backward_plain(params, plan, gmode, coords,
                                                 cot), cfg)
        torch.cuda.synchronize()
        cerr = gate(f"C h={h}", check_grads, gk, gp, gmode)
        pad = padded_slots(cfg)[0].to(dev)
        zero = bool(torch.all(gk[:, pad] == 0))
        log(f"phase17 C vs plain at h={h} (padded to 64) on the refit's "
            f"inputs, {k} windows of {n} ({gmode} grad tier): max abs "
            f"{cerr:.3e} of max |grad| {float(gp.abs().max()):.3e}; padded "
            f"slots' gradients exactly 0: {zero}")
        if not zero:
            fails.append(f"C h={h} padded slots")
        del gk, gp, params, cot
    tc = tloop.TrainConfig(learning_rate=7e-4, grad_clip_norm=1.0)
    for h in sorted({p[0] for p in WIDTH_POINTS}):
        cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=1800.0)
        model = build_model("mlp", cfg, fused=True, approx_sin=True)
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(SEED), tc, dev,
            windows=targets.shape[0])
        vstep, to_flat, _, _ = tloop.make_vmapped_fused_step(model, tc,
                                                             coords)
        fs = to_flat(state)
        pad, snake = (m.to(dev) for m in padded_slots(cfg))

        def held(s):
            """Every padded slot of params, best, mu and nu bit-zero, the
            padded snake a of params and best bit-one."""
            return (all(bool(torch.all(t[:, pad & ~snake] == 0))
                        for t in (s.params, s.best_params))
                    and all(bool(torch.all(t[:, pad] == 0))
                            for t in (s.mu, s.nu))
                    and all(bool(torch.all(t[:, snake] == 1.0))
                            for t in (s.params, s.best_params)))

        a, b, gerr = steps_kernel_vs_plain(cfg, tc, coords, targets, fs)
        torch.cuda.synchronize()
        errs = gate(f"D h={h} vs plain", check_state, a, b, tc.learning_rate,
                    gmode)
        errs = errs if isinstance(errs, dict) else {"state": errs}
        log(f"phase17 D vs plain at h={h} (padded to 64, {gmode} grad tier),"
            f" 3 steps from one state over {targets.shape[0]} windows of {n}:"
            f" first-step gradients max abs {gerr:.3e}; after 3 steps max abs"
            f" " + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
            + f" (lr {tc.learning_rate}); padded slots held in the kernel / "
            f"plain state: {held(a)} / {held(b)}")
        if not (held(a) and held(b)):
            fails.append(f"D h={h} vs plain padded slots")
        del a, b
        counters["siren_step"].launches = 0
        for _ in range(WIDTH_D_STEPS):
            fs, (loss, _) = vstep(fs, targets)
        torch.cuda.synchronize()
        launches = counters["siren_step"].launches
        ok = held(fs)
        log(f"phase17 D at h={h} (padded to 64), {WIDTH_D_STEPS} steps over "
            f"{targets.shape[0]} windows of {n}: {launches} launches, final "
            f"mean loss {float(loss.mean()):.6g}; padded slots of params, "
            f"best, mu and nu bit-zero, padded snake a bit-one: {ok}")
        if not ok or launches != WIDTH_D_STEPS:
            fails.append(f"D h={h}")
    if fails:
        raise AssertionError(f"phase 17 failed: {fails}")
    return out


def sharded_fits_torchrun(nproc):
    """Phase 15's NCCL leg: this script under ``torchrun --nproc-per-node
    nproc``, one card a rank, each rank running ``sharded_fits_rank``.
    Returns rank 0's record of the fits."""
    path = os.path.join(WORK, NCCL_FITS)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), os.path.join(HERE, "chip_smoke.py")],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    log(f"phase15 torchrun --nproc-per-node {nproc} chip_smoke.py (the "
        f"runner mlp fits, one card a rank): rc={proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or not os.path.exists(path):
        log(proc.stderr[-4000:])
        raise AssertionError(f"phase 15: the fits on {nproc} cards failed")
    with open(path) as f:
        res = json.load(f)
    if res["backend"] != "nccl" or res["size"] != nproc:
        raise AssertionError(f"phase 15: {nproc} cards ran {res['size']} "
                             f"ranks on {res['backend']}, not NCCL")
    return res


def sharded_fits_rank(torch):
    """One rank of phase 15's NCCL leg (this script started by ``torchrun``,
    ``WORLD_SIZE`` > 1): a 3-step warm-up fit, which also sets up NCCL's
    communicator at its first collective, then the runner mlp fits, raw and
    RFF, through ``fit`` on the default group's mesh, RUNNER_SHARD_STEPS
    steps from seed SEED, every launch count set to 0 before each and summed
    over the ranks after.  Rank 0 writes each fit's first and final loss,
    steps/s, launches, and whether every rank's final state and loss
    history equal its own bit for bit, to NCCL_FITS."""
    import torch.distributed as dist
    from inraudio_tpu_torch.data import waveform_fitting
    from inraudio_tpu_torch.parallel import make_mesh
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.tree import tree_leaves
    mesh = make_mesh("cuda")
    problem = waveform_fitting(os.path.join(WORK, "runner_clip.wav"), 7.0)
    x, y = problem.coords, problem.targets
    stc = tloop.TrainConfig(total_steps=RUNNER_SHARD_STEPS,
                            scan_chunk=RUNNER_SHARD_STEPS)
    tloop.fit(runner_model(None), x, y,
              dataclasses.replace(stc, total_steps=3), mesh=mesh)
    counters = launch_counters()
    out = {"backend": mesh.backend, "size": mesh.size}
    for name, rb in runner_shapes(torch, mesh.device).items():
        model = runner_model(rb)
        s0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                    stc, mesh.device)
        for c in counters.values():
            c.launches = 0
        r = tloop.fit(model, x, y, stc, state=s0, mesh=mesh)
        cnt = mesh.all_reduce_(torch.tensor(
            [float(c.launches) for c in counters.values()],
            device=mesh.device))
        mine = torch.cat([t.reshape(-1).to(torch.float64) for t in
                          tree_leaves(r.state)] + [torch.as_tensor(
                              r.loss_history, dtype=torch.float64,
                              device=mesh.device)])
        every = mesh.all_gather(mine[None])
        out[name] = {"first": float(r.loss_history[0]),
                     "final": float(r.loss_history[-1]),
                     "steps_s": r.steps_per_sec,
                     "ranks_equal": bool((every == every[:1]).all()),
                     "launches": {k: int(v) for k, v in
                                  zip(counters, cnt.tolist())}}
    if mesh.rank == 0:
        with open(os.path.join(WORK, NCCL_FITS), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def hop_median_snr(np, ref, rec, hop):
    """Median over the clip's hop-long segments of each segment's SNR, dB:
    a fit-quality statistic that a few chaotic windows do not move."""
    m = len(ref) // hop * hop
    r = ref[:m].astype(np.float64).reshape(-1, hop)
    e = (rec[:m] - ref[:m]).astype(np.float64).reshape(-1, hop)
    return float(np.median(10 * np.log10(
        np.sum(r * r, axis=1) / np.maximum(np.sum(e * e, axis=1), 1e-30))))


def train_population(np, torch, dev, clip, name, spec):
    """(cfg, model, train config, windows (k, n), coords, targets (k, n))
    for one shape, the initial state drawn from SEED."""
    from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
    from inraudio_tpu_torch.train.loop import TrainConfig
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    chunk_signal)
    cfg = SirenSnakeTanhConfig(hidden_features=128, num_sine=2, num_snake=2,
                               first_omega_0=spec["omega"],
                               hidden_omega_0=30.0)
    model = build_model("mlp", cfg, fused=True, approx_sin=True)
    tc = TrainConfig(**TRAIN[name])
    chunks, n, _ = chunk_signal(clip, FS, MultiINRConfig(
        chunk_seconds=spec["chunk_seconds"], overlap_fraction=spec["overlap"]))
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    targets = torch.from_numpy(chunks / scales[:, None]).to(dev)
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    return cfg, model, tc, coords, targets


def train_phases(np, torch, dev, clip, codec, ss, st, sf):
    """Phases 5-7: the training kernels against their plain versions, the
    encode served through the entry points, and the training timings."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import write_wav
    from inraudio_tpu_torch.dsp import calculate_snr
    from inraudio_tpu_torch.train.loop import TrainConfig, init_train_state
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    multi_inr_fit,
                                                    multi_inr_fit_many)
    from test_torch_cuda import (check_grads, check_state, clone_state,
                                 steps_kernel_vs_plain)

    out = {}
    spec = SHAPES["headline"]
    cfg, model, tc, coords, targets = train_population(
        np, torch, dev, clip, "headline", spec)
    k, n = targets.shape
    state = init_train_state(model, torch.Generator().manual_seed(SEED), tc,
                             dev, windows=k)
    fs0 = ss.flat_state_from_train_state(state, cfg)
    kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain)

    # ---- phase 5: D and C against their plain versions ----
    gmode = st.grad_dot_mode()
    a, b, gerr = steps_kernel_vs_plain(cfg, tc, coords, targets, fs0)
    torch.cuda.synchronize()
    errs = check_state(a, b, tc.learning_rate, gmode)
    out["step_err"] = max(errs["params"], errs["best_params"])
    lr = tc.learning_rate
    shares = {t: float(((a.params - b.params).abs() <= t * lr).float().mean())
              for t in (1e-3, 1e-2, 1e-1)}
    log(f"phase5 D vs plain ({gmode} grad tier, k={k} n={n} h=128): first-"
        f"step gradients max abs {gerr:.3e}; after 3 steps max abs "
        + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
        + f" (lr {lr}); params within 1e-3/1e-2/1e-1 lr: "
        + "/".join(f"{v:.5f}" for v in shares.values())
        + "; loss, step, lr, best_iter, plateau state within tolerance")
    s1, (l1, _) = kstep(clone_state(a), coords, targets)
    s2, (l2, _) = kstep(clone_state(a), coords, targets)
    torch.cuda.synchronize()
    if not (torch.equal(l1, l2) and all(torch.equal(x, y)
                                        for x, y in zip(s1, s2))):
        raise AssertionError("two kernel steps from one state differ")
    log("phase5 two kernel steps from one state: bit-equal")
    del s1, s2, b
    params = {"layers": [{key: v.contiguous() for key, v in p.items()}
                         for p in st.unflatten_params(a.params,
                                                      cfg)["layers"]]}
    plan = sf.stack_plan(cfg, approx_sin=True)
    cot = (torch.randn(k, n, 1, device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED))
           * (2.0 / n))
    gk = st.flatten_params(st.SIREN_BWD(params, cfg, plan, gmode, coords,
                                        cot), cfg)
    gp = st.flatten_params(st.backward_plain(params, plan, gmode, coords,
                                             cot), cfg)
    torch.cuda.synchronize()
    out["bwd_err"] = check_grads(gk, gp, gmode)
    log(f"phase5 C vs plain ({gmode} grad tier): max abs {out['bwd_err']:.3e}"
        f" of max |grad| {float(gp.abs().max()):.3e}")
    del gk, gp

    # ---- phase 6: serving encode through the entry points ----
    counters = {"siren_stack": sf.SIREN_STACK, "siren_step": ss.SIREN_STEP,
                "siren_bwd": st.SIREN_BWD}
    for c in counters.values():
        c.launches = 0
    ccfg = codec.CodecConfig(
        chunk_seconds=spec["chunk_seconds"], overlap_fraction=spec["overlap"],
        first_omega_0=spec["omega"], total_steps=FIT_STEPS, quantize=None,
        fused=True, seed=SEED, **TRAIN["headline"])
    t0 = time.perf_counter()
    payload = codec.encode(clip, FS, ccfg, device=dev)
    t1 = time.perf_counter()
    path = codec.save_inr(os.path.join(WORK, "fit_headline.npz"), payload)
    _, rec = codec.decode(codec.load_inr(path), dev)
    snr_k = float(calculate_snr(clip, rec))
    log(f"phase6 codec.encode(fused) headline: {FIT_STEPS} steps in "
        f"{t1 - t0:.2f} s (init, fit, fit-SNR estimate), header fit_snr_db "
        f"{payload['meta']['fit_snr_db']}, save -> load -> decode on the "
        f"card: SNR {snr_k:.3f} dB")
    wav = os.path.join(WORK, "clip.wav")
    write_wav(wav, FS, clip)
    enc_path = os.path.join(WORK, "cli_codec_default.inra")
    argv = ["encode", "--device", "cuda", "--fused", "--quantize", "int8",
            "--refit-steps", "50", "--total-steps", str(CLI_STEPS),
            "--input", wav, "--output", enc_path]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"phase6 CLI {' '.join(argv[:9])} ...: rc={rc} {json.dumps(stats)}")
    if rc != 0 or not np.isfinite(stats["snr_db"]):
        raise AssertionError("CLI encode failed")
    out["launches"] = {name: c.launches for name, c in counters.items()}
    out["payloads"] = {"headline": path, "codec_default": stats["path"]}
    log(f"phase6 kernel launches in the served encodes: {out['launches']}")
    if (out["launches"]["siren_step"] < FIT_STEPS + CLI_STEPS
            or out["launches"]["siren_bwd"] < 50
            or out["launches"]["siren_stack"] < 50):
        raise AssertionError("the encode path did not run through every "
                             "kernel")
    # The same fit through the plain step, from the same initial params.
    # Past ~150 steps single windows' Adam trajectories part (bf16 rounding
    # flips, then summation order), and the clip SNR is set by the few
    # worst windows: 40-60% of the error sits in 5 of 669 windows.  So the
    # 0.5 dB gate on the clip SNR is taken at CMP_STEPS, and at FIT_STEPS
    # the median per-hop SNR is gated, each on two seeds.  Beside each pair
    # the control: a kernel fit from the init times (1 + 2^-22), which
    # shows how far a 1-ulp change of the start moves the same statistic.
    mcfg = MultiINRConfig(chunk_seconds=spec["chunk_seconds"],
                          overlap_fraction=spec["overlap"])
    hop = payload["meta"]["hop"]

    def fit_decode(fmodel, steps, seed):
        """multi_inr_fit_many from ``seed`` -> (clip SNR, median per-hop
        SNR), decoded through codec.decode with the served header."""
        res = multi_inr_fit_many(
            fmodel, [clip], FS, mcfg,
            TrainConfig(total_steps=steps, **TRAIN["headline"]), seed=seed,
            device=dev)[0]
        pl = {**payload, "scales": res.chunk_scales.astype(np.float32),
              "params": {"layers": [
                  {key: v.cpu().contiguous() for key, v in p.items()}
                  for p in res.states.best_params["layers"]]}}
        _, r = codec.decode(pl, dev)
        return float(calculate_snr(clip, r)), hop_median_snr(np, clip, r, hop)

    pmodel = dataclasses.replace(
        model, fused_step_ctx={**model.fused_step_ctx, "step": ss.step_plain})
    ulp_model = dataclasses.replace(model, init=lambda g, d, windows=None: {
        "layers": [{key: v * (1.0 + 2.0 ** -22) for key, v in p.items()}
                   for p in model.init(g, d, windows)["layers"]]})
    # the kernel side of seed SEED is the served encode, at both lengths
    pay_c = codec.encode(clip, FS, dataclasses.replace(
        ccfg, total_steps=CMP_STEPS), device=dev)
    _, rec_c = codec.decode(pay_c, dev)
    served_fits = {
        CMP_STEPS: (float(calculate_snr(clip, rec_c)),
                    hop_median_snr(np, clip, rec_c, hop)),
        FIT_STEPS: (snr_k, hop_median_snr(np, clip, rec, hop))}
    agree = []
    for steps, stat, limit in ((CMP_STEPS, 0, SNR_AGREE_DB),
                               (FIT_STEPS, 1, SNR_AGREE_DB_MEDIAN)):
        for seed in CMP_SEEDS:
            kern = (served_fits[steps] if seed == SEED
                    else fit_decode(model, steps, seed))
            plain = fit_decode(pmodel, steps, seed)
            ulp = fit_decode(ulp_model, steps, seed)
            diff = abs(kern[stat] - plain[stat])
            agree.append(diff <= limit)
            log(f"phase6 {steps} steps seed {seed}: clip SNR kernel "
                f"{kern[0]:.3f} / plain {plain[0]:.3f} / perturbed kernel "
                f"{ulp[0]:.3f} dB; median per-hop SNR kernel {kern[1]:.3f} "
                f"/ plain {plain[1]:.3f} / perturbed kernel {ulp[1]:.3f} dB;"
                f" gated: {('clip', 'median per-hop')[stat]} |kernel - "
                f"plain| {diff:.3f} dB (limit {limit} dB), control |kernel -"
                f" perturbed| {abs(kern[stat] - ulp[stat]):.3f} dB")
    if not (np.isfinite(rec).all() and rec.shape == clip.shape
            and all(agree)):
        raise AssertionError("kernel fit and plain-step fit disagree")

    # ---- phase 7: training timings ----
    state = clone_state(a)
    out["step_ms"] = cuda_ms(torch, lambda: kstep(state, coords, targets), 20)
    out["step_plain_ms"] = cuda_ms(torch, lambda: pstep(state, coords,
                                                        targets), 5)
    step_ms2 = cuda_ms(torch, lambda: kstep(state, coords, targets), 20)
    log(f"phase7 D whole step, headline: kernel {out['step_ms']:.3f}/"
        f"{step_ms2:.3f} ms ({1e3 / out['step_ms']:.1f} steps/s), plain "
        f"{out['step_plain_ms']:.3f} ms")
    out["step_ms"] = min(out["step_ms"], step_ms2)
    out["bwd_ms"] = cuda_ms(torch, lambda: st.SIREN_BWD(
        params, cfg, plan, gmode, coords, cot), 10)
    out["bwd_plain_ms"] = cuda_ms(torch, lambda: st.backward_plain(
        params, plan, gmode, coords, cot), 5)
    log(f"phase7 C backward, headline: kernel {out['bwd_ms']:.3f} ms, plain "
        f"{out['bwd_plain_ms']:.3f} ms")
    # where a kernel step's time goes: the grad accumulation's kernels
    # (the weights' bf16 split, the sweep, dW), the reduce and the epilogue
    # (clip + Adam + best: the scale and Adam kernels on one reduce's
    # output), each timed apart, the whole of D, and the step with its (k,)
    # plateau / best bookkeeping in torch ops
    g = st.validate_grad_launch(state.params, cfg, plan, coords)
    tp = st.tc_plan(g, gmode)
    split = tc_split_ms(torch, st, g, coords, state.params, 10,
                        targets=targets, gmode=gmode)
    out["split"] = split
    grad_ms = split["siren_wsplit"] + split["siren_sweep"] + split["siren_dw"]
    reduce_ms = split["siren_reduce"]
    kg = tp.windows
    tf = (state.step + 1).to(torch.float32)
    c1, c2 = 1.0 - 0.9 ** tf, 1.0 - 0.999 ** tf
    d_ms = cuda_ms(torch, lambda: ss.SIREN_STEP(
        state.params, state.mu, state.nu, state.best_params, coords, targets,
        state.lr, c1, c2, state.best_loss, cfg, plan, gmode,
        tc.grad_clip_norm), 10)
    lib = st.TRAIN_LIBRARY()
    stream = torch.cuda.current_stream().cuda_stream
    grads, sq_part, loss_part = st.grad_reduce(
        lib, g, coords, state.params, stream, targets=targets, gmode=gmode)
    e = clone_state(state)
    eloss, escale = (torch.empty((k,), device=dev) for _ in range(2))
    adam_ms = cuda_ms(torch, lambda: ss.launch_adam(
        lib, grads, sq_part, loss_part, e.params, e.mu, e.nu, e.best_params,
        eloss, escale, e.lr, c1, c2, e.best_loss, tc.grad_clip_norm,
        stream), 20)
    P = g.layout.size
    improved = int((eloss < e.best_loss).sum())
    # g, p, mu, nu read and p, mu, nu written for every window, best (the
    # old p) for the windows whose loss improved; ~12 fp32 operations an
    # element
    out["adam_bound"] = bound(4 * P * (7 * k + improved), 0, 12 * k * P)
    out["adam_ms"] = adam_ms
    del grads, sq_part, loss_part, e
    log(f"phase7 D epilogue (clip + Adam + best: siren_scale_kernel + "
        f"siren_adam_kernel, {k * ss.adam_spans(P)} CTAs), headline, "
        f"timed directly: {adam_ms:.4f} ms, bound "
        f"{out['adam_bound'][0]:.4f} ms ({out['adam_bound'][1]}; "
        f"{improved} of {k} windows write best), "
        f"{100 * out['adam_bound'][0] / adam_ms:.1f}% of the bound")
    log(f"phase7 D breakdown, headline ({-(-k // kg)} window groups of <= "
        f"{kg}, {tp.slices} row slices a window, passes of <= {tp.units} "
        f"units): grad accumulation {grad_ms:.3f} ms (weight split "
        f"{split['siren_wsplit']:.3f}, sweep {split['siren_sweep']:.3f}, dW "
        f"{split['siren_dw']:.3f}), reduce {reduce_ms:.3f} ms, clip + Adam + "
        f"best {adam_ms:.3f} ms, launch gaps "
        f"{d_ms - grad_ms - reduce_ms - adam_ms:.3f} ms (D {d_ms:.3f} ms), "
        f"plateau / best bookkeeping {out['step_ms'] - d_ms:.3f} ms (step "
        f"{out['step_ms']:.3f} ms)")
    log(f"phase7 headline {tc_bytes_line(st, g, gmode)}")
    del a, state, params
    for name in SHAPES:
        sp = SHAPES[name]
        fcfg, fmodel, ftc, _, _ = train_population(np, torch, dev, clip, name,
                                                   sp)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = multi_inr_fit(fmodel, clip, FS, MultiINRConfig(
            chunk_seconds=sp["chunk_seconds"], overlap_fraction=sp["overlap"]),
            dataclasses.replace(ftc, total_steps=100, scan_chunk=50),
            seed=SEED, device=dev)
        log(f"phase7 fit {name}: k={r.num_chunks} n={r.chunk_length}, 100 "
            f"steps in {r.train_time_s:.3f} s -> "
            f"{100 / r.train_time_s:.1f} steps/s, "
            f"{100 * r.num_chunks * r.chunk_length / r.train_time_s / 1e6:.1f}"
            f" M window-samples/s, peak device memory "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
            f"above the {base / 2**20:.1f} MiB held before")
    return out


def serving_phases(np, torch, dev, clip, codec, sf, trained):
    """Phases 18-20: the modulated codec through the CLI on the card, the
    decode serving paths (decode_many, decode_stream) against decode with
    the stack kernel's launches read around them and the decode tiers'
    floors measured on trained payloads, and the fit-multi CLI."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import write_wav
    from inraudio_tpu_torch.dsp import calculate_snr
    from inraudio_tpu_torch.utils.observability import read_metrics

    out = {"launches": {"siren_step": 0, "siren_stack": 0}}
    counters = launch_counters()
    wav = os.path.join(WORK, "clip.wav")
    write_wav(wav, FS, clip)

    def cli(phase, argv):
        """One in-process CLI call -> (its JSON line, seconds, launches)."""
        for c in counters.values():
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        dt = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        lines = buf.getvalue().strip().splitlines()
        rec = json.loads(lines[-1]) if rc == 0 and lines else {}
        shown = [a for a in argv if not a.startswith(WORK)]
        log(f"{phase} CLI {' '.join(shown)}: rc={rc} in {dt:.1f} s "
            f"{json.dumps(rec)}")
        if rc != 0 or not np.isfinite(rec.get("snr_db", np.nan)):
            raise AssertionError(f"{phase}: CLI {argv[0]} failed")
        return rec, dt, launches

    # ---- phase 18: the modulated codec on the card ----
    mod_paths = {}
    for name, extra, point in MOD_ENCODES:
        rec, dt, _ = cli("phase18", [
            "encode", "--device", "cuda", "--modulated", "--total-steps",
            str(MOD_STEPS), *extra, "--input", wav, "--output",
            os.path.join(WORK, f"{name}.inra")])
        payload = codec.load_inr(rec["path"])
        meta = payload["meta"]
        if meta.get("codec") != "modulated":
            raise AssertionError(f"phase18 {name}: not a modulated payload")
        mod_paths[name] = rec["path"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs, full = codec.decode(payload, dev)
        t1 = time.perf_counter()
        _, cpu = codec.decode(payload, "cpu")
        err = float(np.max(np.abs(full - cpu)))
        seek_err = 0.0
        for a, b in MOD_SEEKS:
            _, part = codec.decode_range(payload, a, b, dev)
            seek_err = max(seek_err, float(np.max(np.abs(
                part - full[round(a * FS):round(b * FS)]))))
        snr = float(calculate_snr(clip, full))
        log(f"phase18 {name}: k={meta['num_chunks']} n="
            f"{meta['chunk_length']} h={meta['model']['hidden_features']} "
            f"segments={meta['num_segments']} mod_dim={meta['mod_dim']} "
            f"quantize={meta['quantize']}; {MOD_STEPS} steps: encode "
            f"{rec['encode_s']} s, {rec['file_bits_per_sample']:.4f} bits/"
            f"sample on disk, SNR {snr:.3f} dB (the JAX package's "
            f"TPU-calibrated point {point}: {MOD_TABLE[point]}); decode on "
            f"the card {(t1 - t0) * 1e3:.1f} ms, max |card - CPU| {err:.3e} "
            f"(limit {TRAINED_ATOL}); 3 seeks max |range - full slice| "
            f"{seek_err:.3e} (limit {MOD_RANGE_ATOL})")
        if not (fs == FS and full.shape == clip.shape and np.isfinite(
                full).all() and err <= TRAINED_ATOL
                and seek_err <= MOD_RANGE_ATOL):
            raise AssertionError(f"phase18 {name}: the card's decode "
                                 "disagrees")
    for target, kind, extra in PLAN_TARGETS:
        rec, dt, launches = cli("phase18", [
            "encode", "--device", "cuda", "--target-bps", str(target),
            "--total-steps", str(MOD_STEPS), *extra, "--input", wav,
            "--output", os.path.join(WORK, f"plan{target}.inra")])
        meta = codec.load_inr(rec["path"])["meta"]
        point = (f"mod_h{meta['model']['hidden_features']}_i8"
                 if kind == "modulated" else
                 f"{meta['model']['hidden_features']} {meta['quantize']}")
        log(f"phase18 --target-bps {target}: planned {rec['codec']} "
            f"(expected {kind}), h={meta['model']['hidden_features']} "
            f"quantize={meta['quantize']}, {MOD_STEPS} steps: "
            f"{rec['file_bits_per_sample']:.4f} bits/sample on disk, SNR "
            f"{rec['snr_db']:.3f} dB (TPU-calibrated {point}: "
            f"{MOD_TABLE.get(point)}); launches {launches}")
        if rec["codec"] != kind:
            raise AssertionError(f"phase18: --target-bps {target} planned "
                                 f"{rec['codec']}, expected {kind}")
        if kind == "per_chunk" and launches["siren_step"] != MOD_STEPS:
            raise AssertionError("phase18: the per-window encode did not "
                                 "run through kernel D once a step")
        for key in out["launches"]:
            out["launches"][key] += launches[key]

    # ---- phase 19: decode serving ----
    head = codec.load_inr(trained["headline"])
    cdef = codec.load_inr(trained["codec_default"])
    mod = codec.load_inr(mod_paths["mod"])
    payloads = [head, cdef, mod, head]
    singles = [codec.decode(p, dev) for p in payloads]
    for c in counters.values():
        c.launches = 0
    many = codec.decode_many(payloads, dev)
    stack_many = counters["siren_stack"].launches
    equal = [fs == fs1 and np.array_equal(a, b)
             for (fs, a), (fs1, b) in zip(many, singles)]
    log(f"phase19 decode_many over [headline, codec_default, modulated, "
        f"headline] (trained payloads of phases 6 and 18): each equal to "
        f"its own decode byte for byte: {equal}; stack-kernel launches "
        f"{stack_many} (2 groups)")
    if not all(equal) or stack_many != 2:
        raise AssertionError("phase19: decode_many differs from decode")
    stream_equal = []
    for name, p, (_, full) in (("headline", head, singles[0]),
                               ("modulated", mod, singles[2])):
        t0 = time.perf_counter()
        blocks = [b for _, b in codec.decode_stream(p, dev, block_s=1.0)]
        t1 = time.perf_counter()
        cat = np.concatenate(blocks)
        err = float(np.max(np.abs(cat - full)))
        ok = (np.array_equal(cat, full) if name == "headline"
              else err <= MOD_RANGE_ATOL)
        stream_equal.append(ok)
        log(f"phase19 decode_stream {name}: {len(blocks)} blocks of 1 s in "
            f"{(t1 - t0) * 1e3:.1f} ms, max |stream - decode| {err:.3e} "
            f"({'bit-equal required' if name == 'headline' else 'limit'} "
            f"{0 if name == 'headline' else MOD_RANGE_ATOL})")
    if not all(stream_equal):
        raise AssertionError("phase19: decode_stream differs from decode")
    out["launches"]["siren_stack"] += stack_many

    def events_ms(fn, reps=3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for label, group in (("per-window", payloads[:2] + payloads[3:]),
                         ("all four", payloads)):
        many_ms = events_ms(lambda: codec.decode_many(group, dev))
        one_ms = events_ms(lambda: [codec.decode(p, dev) for p in group])
        log(f"phase19 {label} ({len(group)} payloads, from host): "
            f"decode_many {many_ms:.2f} ms, {len(group)} decodes "
            f"{one_ms:.2f} ms (CUDA events around the calls; no claim)")
    # the decode tiers' floors, measured: each tier's decode against the
    # exact apply's on a trained payload, beside the floor the routing
    # table holds (the JAX package's, measured on a TPU)
    floors = {}
    for name, p in (("headline", head), ("codec_default", cdef)):
        meta, model, params = codec._payload_model_params(p, True, dev)
        cfg = codec._model_cfg_from_meta(meta)
        coords = torch.from_numpy(codec._decode_grid(meta["chunk_length"],
                                                     1)).to(dev)
        _, exact = codec.decode(p, dev, fused=False)
        high = cfg.first_omega_0 >= sf._HIGH_PHASE_OMEGA
        for floor, high_floor, kw in sf._DECODE_TIERS:
            kw = dict(kw)
            if kw.get("compute_dtype") == "bfloat16":
                kw["compute_dtype"] = torch.bfloat16
            outs = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
            _, rec = codec._stitch_outs(p, outs.cpu().numpy(), 1)
            snr = 10 * np.log10(float(np.sum(exact.astype(np.float64) ** 2))
                                / max(float(np.sum((rec - exact).astype(
                                    np.float64) ** 2)), 1e-30))
            table = high_floor if high else floor
            tier = "-".join(f"{k}={v}" for k, v in sorted(kw.items()))
            floors[(name, tier)] = (snr, table)
            log(f"phase19 tier floor {name} (omega0 {cfg.first_omega_0}, "
                f"fit_snr_db {meta.get('fit_snr_db')}) {tier}: decode vs "
                f"exact apply SNR {snr:.2f} dB, table floor {table} dB"
                f"{'  BELOW THE TABLE' if snr < table else ''}")
    out["tier_floors"] = floors

    # ---- phase 20: the fit-multi CLI at the headline shape ----
    metrics = os.path.join(WORK, "fit_multi.jsonl")
    rec, dt, launches = cli("phase20", [
        "fit-multi", "--device", "cuda", "--fused", "--total-steps",
        str(FIT_MULTI_STEPS), "--input", wav, "--output",
        os.path.join(WORK, "fit_multi.wav"), "--metrics", metrics])
    rounds = read_metrics(metrics)
    log(f"phase20 fit-multi: {rec['num_chunks']} windows, "
        f"{FIT_MULTI_STEPS} steps in {rec['train_time_s']} s -> "
        f"{FIT_MULTI_STEPS / rec['train_time_s']:.1f} steps/s, SNR "
        f"{rec['snr_db']} dB; launches D {launches['siren_step']}, A "
        f"{launches['siren_stack']}; metrics records {rounds}")
    want_rounds = -(-FIT_MULTI_STEPS // 500)
    if (launches["siren_step"] != FIT_MULTI_STEPS
            or launches["siren_stack"] != 1
            or rec["num_chunks"] != SHAPES["headline"]["expect"][2]
            or len(rounds) != want_rounds
            or rounds[-1]["step"] != FIT_MULTI_STEPS
            or not all(r["event"] == "round" and np.isfinite(r["loss"])
                       for r in rounds)):
        raise AssertionError("phase20: fit-multi did not run its path")
    for key in out["launches"]:
        out["launches"][key] += launches[key]
    return out


def spectral_model(arch, in_features):
    """The runner's CLI-default model for a spectral fit: the production
    mlp (fused) or KAN([d, 256, 256, 1]) (fused)."""
    from inraudio_tpu_torch.experiments import runner as trunner
    return trunner.build_arch(arch, in_features, RUNNER_H, 2, 2, 0,
                              RUNNER_OMEGA, 30.0, 0.5, fused=True)


def spectral_phases(np, torch, dev, clip):
    """Phases 21-23: the spectral fits at the CLI's defaults on the clip.
    21: kernels D and E with the mdct target's per-row weight (the
    hearing-threshold mask) against their plain versions beside the 1-ulp
    control, an all-ones weight bit-equal to no weight, repeat calls
    bit-equal, two shards' E summing to D's, d = 2 on both routes; 22: the
    fit CLI of every method, served in process with the launch counts read
    around each run, each checkpoint loaded and decoded on the card and on
    the CPU, and the weighted mdct fit sharded over two thread ranks; 23:
    timings (CUDA events) of the weighted and unweighted steps, the
    autograd steps' parts, the DSP's basis matmuls against torch.fft, and
    each fit's peak memory."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import write_wav
    from inraudio_tpu_torch.dsp import (griffin_lim, hann_window_periodic,
                                        istmdct, stft_magnitude, stmdct)
    from inraudio_tpu_torch.eval.decode import decode_problem
    from inraudio_tpu_torch.eval.metrics import reconstruction_snr
    from inraudio_tpu_torch.experiments import runner as trunner
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.parallel import normalise_weight
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.checkpoint import load_checkpoint
    from inraudio_tpu_torch.train.losses import mix_loss
    from inraudio_tpu_torch.tree import tree_leaves, tree_map
    from test_torch_cuda import (GRAD_BF16_MAX_RTOL, GRAD_F32_RTOL,
                                 LOSS_RTOL, RFF_CTRL_X, check_rff_steps,
                                 clone_state, is_bf16_grad, perturb_layer0,
                                 run_thread_ranks)

    wav = os.path.join(WORK, "spectral_clip.wav")
    write_wav(wav, FS, clip)
    problem = trunner.build_problem("mdct", wav, 7.0, n=SPECTRAL_N,
                                    perceptual_mask=True, device=dev)
    x, y = problem.coords, problem.targets
    n = x.shape[0]
    if (n, problem.in_features) != SPECTRAL_ROWS:
        raise AssertionError(f"mdct target: {n} rows of {problem.in_features}"
                             f" columns, expected {SPECTRAL_ROWS}")
    coords = torch.from_numpy(x).to(dev)
    targets = torch.from_numpy(y[:, 0]).to(dev)[None]
    w = torch.from_numpy(normalise_weight(problem.loss_weight)[:, 0]).to(
        dev)[None]
    model = spectral_model("mlp", 2)
    cfg = model.config
    plan = sf.stack_plan(cfg, approx_sin=True)
    gmode = st.grad_dot_mode()
    tc = tloop.TrainConfig()  # the runner's defaults: lr 1e-3, no clip
    out, fails = {}, []
    log(f"phase21 mdct target: n={SPECTRAL_N}, {problem.height} bins x "
        f"{problem.width} frames = {n} rows of 2 coordinates; weight "
        f"(hearing-threshold mask) in [{float(w.min()):.4f}, "
        f"{float(w.max()):.4f}], mean {float(w.mean()):.6f}")

    # ---- phase 21: weighted D and E against their plain versions ----
    state = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                   tc, dev, windows=1)
    gaps = {}
    for tier in (gmode, "highest") if gmode != "highest" else (gmode,):
        os.environ["INRAUDIO_GRAD_PRECISION"] = tier
        try:
            a, g = check_rff_steps(cfg, tc, coords, targets, state, None,
                                   steps=3 if tier == gmode else 1,
                                   weight=w)
            verdict = "ok"
        except AssertionError as e:
            g, verdict = e.args[0] if e.args else {}, "FAILED"
            fails.append(f"weighted D {tier}")
        finally:
            os.environ["INRAUDIO_GRAD_PRECISION"] = gmode
        route = "tensor-core" if st.tc_route(plan, tier) else "FMA"
        log(f"phase21 weighted D vs step_plain with the weight ({tier} grad "
            f"tier, {route} route, d=2), from one state: {g}; {verdict}")
        gaps[tier] = g
    out["step_err"] = gaps.get(gmode, {}).get("grad", float("nan"))
    fs = ss.flat_state_from_train_state(state, cfg)
    # negative control: the plain step without the weight against the plain
    # step with it, from the same state, under the default tier's gates; a
    # D that dropped the weight would be this far from its plain version
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain)
    pw, (lpw, _) = pstep(clone_state(fs), coords, targets, w)
    pu, (lpu, _) = pstep(clone_state(fs), coords, targets)
    torch.cuda.synchronize()
    gd = gaps.get(gmode, {})
    nl = float((lpu - lpw).abs().max()) / float(lpw.abs().max())
    nl_lim = max(RFF_CTRL_X * gd.get("loss_ctrl", [0.0])[0], LOSS_RTOL)
    ng = float((pu.mu - pw.mu).abs().max())
    ng_lim = max(RFF_CTRL_X * gd.get("grad_ctrl", 0.0), gd.get("grad_tol",
                                                               0.0))
    seen = nl > nl_lim or ng > ng_lim
    log(f"phase21 negative control, plain D without the weight against "
        f"plain D with it ({gmode}): step-0 loss rel {nl:.3e} (limit "
        f"{nl_lim:.3e}), first-step grads (mu) max abs {ng:.3e} (limit "
        f"{ng_lim:.3e}); a weight-dropping D would fail "
        f"{'yes' if seen else 'NO'}")
    if not seen:
        fails.append("weighted D negative control")
    del pw, pu
    kstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True)
    s1, (l1, _) = kstep(clone_state(fs), coords, targets, w)
    s2, (l2, _) = kstep(clone_state(fs), coords, targets, w)
    u0, (lu, _) = kstep(clone_state(fs), coords, targets)
    u1, (lo, _) = kstep(clone_state(fs), coords, targets,
                        torch.ones_like(w))
    torch.cuda.synchronize()
    same = torch.equal(l1, l2) and all(torch.equal(p, q)
                                       for p, q in zip(s1, s2))
    ones = torch.equal(lu, lo) and all(torch.equal(p, q)
                                       for p, q in zip(u0, u1))
    log(f"phase21 two weighted D steps from one state bit-equal {same}; an "
        f"all-ones weight against no weight (loss, params, mu, nu, best) "
        f"bit-equal {ones} (loss {float(lu):.9g}; weighted "
        f"{float(l1):.9g})")
    if not (same and ones):
        fails.append("weighted D determinism / ones")
    # E on the two shards of a 2-rank fit, the weight normalised over the
    # clip and split with the rows
    fs1 = s1
    P = fs1.params.shape[1]
    pert = st.flatten_params(perturb_layer0(st.unflatten_params(
        fs1.params, cfg)), cfg)
    tol = GRAD_BF16_MAX_RTOL if is_bf16_grad(gmode) else GRAD_F32_RTOL
    block = st.tile_rows(RUNNER_H)
    total, errs, ctls = 0, [], []
    for r in range(2):
        cs, ts, limit, sh, ws = _shard_inputs(torch, np, dev, x, y, r, 2,
                                              block,
                                              weight=problem.loss_weight)
        args = (cs, ts, limit, n, cfg, plan, gmode)
        kb = ss.SIREN_GRAD(fs1.params, *args, weight=ws)
        again = ss.SIREN_GRAD(fs1.params, *args, weight=ws)
        pb = ss.grad_plain(fs1.params, *args, weight=ws)
        cb = ss.grad_plain(pert, *args, weight=ws)
        nb = ss.grad_plain(fs1.params, *args)  # negative control: no weight
        empty = ss.SIREN_GRAD(fs1.params, cs, ts, torch.zeros_like(limit),
                              *args[3:], weight=ws)
        torch.cuda.synchronize()
        scale = float(pb[:P].abs().max())
        err, ctl = (float((v - pb)[:P].abs().max()) for v in (kb, cb))
        lerr = abs(float(kb[P] - pb[P])) / float(pb[P])
        lctl = abs(float(cb[P] - pb[P])) / float(pb[P])
        limit_g = max(RUNNER_CTRL_X * ctl, tol * scale)
        limit_l = max(RUNNER_CTRL_X * lctl, LOSS_RTOL)
        nerr = float((nb - pb)[:P].abs().max())
        nlerr = abs(float(nb[P] - pb[P])) / float(pb[P])
        seen = nerr > limit_g or nlerr > limit_l
        ok = (bool(torch.isfinite(kb).all()) and err <= limit_g
              and lerr <= limit_l and torch.equal(kb, again)
              and not empty.any() and seen)
        log(f"phase21 weighted E shard {r} (rows [{sh.start}, "
            f"{sh.start + sh.rows}), {sh.valid} valid): grads max abs "
            f"{err:.3e} of max |grad| {scale:.3e} (limit {limit_g:.3e} = "
            f"max({RUNNER_CTRL_X} x control {ctl:.3e}, {tol} x max)); loss "
            f"rel {lerr:.2e} (control {lctl:.2e}, limit {limit_l:.2e}); "
            f"repeat bit-equal {torch.equal(kb, again)}; limit 0 gives "
            f"zeros {not empty.any()}; negative control (plain E without "
            f"the weight): grads {nerr:.3e}, loss rel {nlerr:.2e}, a "
            f"weight-dropping E would fail {'yes' if seen else 'NO'}; "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"weighted E shard {r}")
        errs.append(err)
        ctls.append(ctl)
        total = total + kb
        del pb, cb, nb, again, empty
    out["grad_err"] = max(errs)
    g = st.validate_grad_launch(fs1.params, cfg, plan, coords)
    grads, _, loss_part = st.grad_reduce(
        st.TRAIN_LIBRARY(), g, coords, fs1.params,
        torch.cuda.current_stream().cuda_stream, targets=targets,
        gmode=gmode, weight=w)
    torch.cuda.synchronize()
    scale = float(grads.abs().max())
    gap = float((total[None, :P] - grads).abs().max())
    lgap = abs(float(total[P] - loss_part.sum())) / float(total[P])
    limit_s = max(RUNNER_CTRL_X * max(ctls), GRAD_F32_RTOL * scale)
    ok = gap <= limit_s and lgap <= LOSS_RTOL
    log(f"phase21 weighted shard 0 + shard 1 against D's weighted grad "
        f"accumulation over all {n} rows: grads max abs {gap:.3e} = "
        f"{gap / scale:.2e} of max |grad| (limit {limit_s:.3e}), loss rel "
        f"{lgap:.2e} (limit {LOSS_RTOL}); {'ok' if ok else 'FAILED'}")
    if not ok:
        fails.append("weighted E sum")
    del grads, loss_part, total, s1, s2, u0, u1
    if fails:
        raise AssertionError(f"phase 21 failed: {fails}")

    # ---- phase 22: served through the entry points ----
    counters = launch_counters()
    served, peaks = {}, {}
    for tag, (method, arch, extra, kw, autograd) in SPECTRAL_FITS.items():
        steps = SPECTRAL_STEPS
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec, ckpt = run_cli_fit(cli_main, "phase22", wav, tag, arch, steps,
                                ["--method", method, *extra])
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 2**20
        cnt = {k: c.launches for k, c in counters.items()}
        served[tag] = cnt
        # an mse fit of the mlp: D every step, the stack kernel in the
        # decode; an autograd fit: the stack kernel and C every step; the
        # KAN: G and H every step
        if arch == "kan":
            want = {"kan_bwd": steps, "siren_step": 0, "siren_bwd": 0}
            least = {"kan_fwd": steps + 1}
        elif autograd:
            want = {"siren_bwd": steps, "siren_step": 0}
            least = {"siren_stack": steps + 1}
        else:
            want = {"siren_step": steps, "siren_bwd": 0}
            least = {"siren_stack": 1}
        ok = (all(cnt[k] == v for k, v in want.items())
              and all(cnt[k] >= v for k, v in least.items()))
        want.update({k: f">={v}" for k, v in least.items()})
        # the checkpoint, loaded and decoded on the card and on the CPU
        prob = trunner.build_problem(method, wav, 7.0, device=dev, **kw)
        m = spectral_model(arch, prob.in_features)
        template = tloop.init_train_state(m, torch.Generator(),
                                          tloop.TrainConfig(), dev)
        params = load_checkpoint(ckpt, template).best_params
        card, rate = decode_problem(m, params, prob, device=dev)
        cpu, _ = decode_problem(m, tree_map(lambda t: t.cpu(), params), prob,
                                device="cpu")
        ref = clip / float(np.max(np.abs(clip)))
        spectral = method in ("mdct", "fft")
        snr = reconstruction_snr(ref if spectral else clip, card,
                                 trim=1024 if spectral else 0)
        if method == "fft":
            dgap = abs(gl_convergence(np, torch, prob, card)
                       - gl_convergence(np, torch, prob, cpu))
            limit_d = SPECTRAL_GL_MARGIN
            what = "spectral convergence of the two Griffin-Lim decodes"
        else:
            # the shifted log's exp multiplies an output's error by the
            # contract's scale
            amp = prob.decode["scale"] if prob.decode.get("takelog") else 1.0
            dgap = float(np.max(np.abs(card - cpu)))
            limit_d = (SPECTRAL_DECODE_RTOL * max(1.0, amp)
                       * float(np.max(np.abs(cpu))))
            what = "max abs sample"
        ok = ok and bool(np.isfinite(card).all()) and dgap <= limit_d
        log(f"phase22 {tag}: launches {cnt} (expected {want}); peak device "
            f"memory {peaks[tag]:.1f} MiB; checkpoint -> load -> "
            f"decode_problem on the card: {card.shape[0]} samples at {rate} "
            f"Hz, SNR {snr:.3f} dB (not gated; the run's record "
            f"{rec['SNR']:.3f} dB); card vs CPU decode {what} {dgap:.3e} "
            f"(limit {limit_d:.3e}); {'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"served {tag}")
        del params, card, cpu
    out["served"], out["peaks"] = served, peaks
    # the weighted mdct fit on two thread ranks (E + F) against one rank
    stc = tloop.TrainConfig(total_steps=SPECTRAL_SHARD_STEPS,
                            scan_chunk=SPECTRAL_SHARD_STEPS)
    s0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                stc, dev)
    one = tloop.fit(model, x, y, stc, state=s0, device=dev,
                    weight=problem.loss_weight)
    ulp = tloop.fit(model, x, y, stc, device=dev, weight=problem.loss_weight,
                    state=s0._replace(params=tree_map(
                        lambda t: t * (1.0 + 2.0 ** -22), s0.params)))
    for c in counters.values():
        c.launches = 0
    res = run_thread_ranks(2, lambda m: tloop.fit(
        model, x, y, stc, state=s0, mesh=m, weight=problem.loss_weight),
        device=dev)
    cnt = {k: c.launches for k, c in counters.items()}
    out["sharded_launches"] = cnt
    l1, lk, lu = (float(one.loss_history[0]), float(one.loss_history[-1]),
                  float(ulp.loss_history[-1]))
    l1s, ls = float(res[0].loss_history[0]), float(res[0].loss_history[-1])
    limit = max(KAN_CMP_CONTROL_X * abs(lk - lu), KAN_CMP_FLOOR_REL * lk)
    same = all(torch.equal(p, q) for p, q in zip(tree_leaves(res[0].state),
                                                  tree_leaves(res[1].state)))
    ok = (abs(l1s - l1) <= LOSS_RTOL * l1 and abs(ls - lk) <= limit and same
          and np.array_equal(res[0].loss_history, res[1].loss_history)
          and cnt["siren_step"] == 0
          and cnt["siren_grad"] == 2 * SPECTRAL_SHARD_STEPS
          and cnt["siren_adam"] == 2 * SPECTRAL_SHARD_STEPS)
    log(f"phase22 weighted mdct fit(mesh=2 ranks on one card, gloo), "
        f"{SPECTRAL_SHARD_STEPS} steps: first loss {l1s:.9g} vs one rank "
        f"{l1:.9g} (rel {abs(l1s - l1) / l1:.2e}, limit {LOSS_RTOL}); final "
        f"loss sharded {ls:.9g} / one rank {lk:.9g} / perturbed one rank "
        f"{lu:.9g}, gated |sharded - one| {abs(ls - lk):.3e} (limit "
        f"{limit:.3e}); ranks equal {same}; launches {cnt}; steps/s sharded "
        f"{res[0].steps_per_sec:.2f}, one rank {one.steps_per_sec:.2f}; "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fails.append("weighted sharded fit")
    del one, ulp, res
    if fails:
        raise AssertionError(f"phase 22 failed: {fails}")

    # ---- phase 23: timings ----
    t = {}
    fs = ss.flat_state_from_train_state(state, cfg)
    t["step_w"] = cuda_ms(torch, lambda: kstep(fs, coords, targets, w), 10)
    t["step"] = cuda_ms(torch, lambda: kstep(fs, coords, targets), 10)
    t["step_w2"] = cuda_ms(torch, lambda: kstep(fs, coords, targets, w), 10)
    pstep = ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=ss.step_plain)
    t["step_w_plain"] = cuda_ms(torch, lambda: pstep(fs, coords, targets, w),
                                2)
    g = st.validate_grad_launch(fs.params, cfg, plan, coords)
    t["split_w"] = tc_split_ms(torch, st, g, coords, fs.params, 10,
                               targets=targets, gmode=gmode, weight=w)
    t["split"] = tc_split_ms(torch, st, g, coords, fs.params, 10,
                             targets=targets, gmode=gmode)
    cs, ts, limit, sh, ws = _shard_inputs(torch, np, dev, x, y, 0, 2, block,
                                          weight=problem.loss_weight)
    eargs = (cs, ts, limit, n, cfg, plan, gmode)
    t["grad_w"] = cuda_ms(torch, lambda: ss.SIREN_GRAD(
        fs.params, *eargs, weight=ws), 10)
    t["grad"] = cuda_ms(torch, lambda: ss.SIREN_GRAD(fs.params, *eargs), 10)
    t["grad_w_plain"] = cuda_ms(torch, lambda: ss.grad_plain(
        fs.params, *eargs, weight=ws), 2)
    n_params = sum(v[0].numel() for layer in st.unflatten_params(
        fs.params, cfg)["layers"] for v in layer.values())
    t["bounds"] = siren_bounds(1, n, RUNNER_H, n_params, d=2, weighted=True)
    t["grad_bound"] = siren_bounds(1, sh.rows, RUNNER_H, n_params, d=2,
                                   weighted=True)[2]
    log(f"phase23 mdct shape ({n} rows, d=2, h={RUNNER_H}): weighted D step "
        f"{t['step_w']:.3f} / {t['step_w2']:.3f} ms against unweighted "
        f"{t['step']:.3f} ms ({100 * (min(t['step_w'], t['step_w2']) / t['step'] - 1):+.2f}%); "
        f"plain weighted step {t['step_w_plain']:.3f} ms; bound "
        f"{t['bounds'][1][0]:.3f} ms ({t['bounds'][1][1]}); sweep weighted "
        f"{t['split_w']['siren_sweep']:.3f} ms against "
        f"{t['split']['siren_sweep']:.3f} (weight split "
        f"{t['split_w']['siren_wsplit']:.3f}, dW "
        f"{t['split_w']['siren_dw']:.3f}, reduce "
        f"{t['split_w']['siren_reduce']:.3f}); weighted E on shard 0 "
        f"({sh.rows} rows) {t['grad_w']:.3f} ms against unweighted "
        f"{t['grad']:.3f}, plain {t['grad_w_plain']:.3f}, bound "
        f"{t['grad_bound'][0]:.3f} ms")
    # the autograd steps, split into the stack forward, the loss and C
    for tag, (method, kwp, ltc) in AUTOGRAD_STEPS.items():
        prob = trunner.build_problem(method, wav, 7.0, device=dev, **kwp)
        m = spectral_model("mlp", prob.in_features)
        c = torch.from_numpy(prob.coords).to(dev)
        yt = torch.from_numpy(prob.targets).to(dev)
        atc = tloop.TrainConfig(**ltc)
        s0 = tloop.init_train_state(m, torch.Generator().manual_seed(SEED),
                                    atc, dev)
        step = tloop.make_train_step(m, atc)
        params = s0.params
        mplan = sf.stack_plan(m.config, approx_sin=True)
        sp = {"layers": [{k: v[None] for k, v in layer.items()}
                         for layer in params["layers"]]}
        fwd = cuda_ms(torch, lambda: sf.SIREN_STACK(sp, mplan, c), 10)
        pred = sf.SIREN_STACK(sp, mplan, c)[0].detach().requires_grad_(True)

        def loss_and_cot():
            val = mix_loss(pred, yt, loss_mode=atc.loss_mode, alpha=atc.alpha,
                           multi_resolution=atc.multi_resolution_stft)
            return torch.autograd.grad(val, [pred])[0]

        lms = cuda_ms(torch, loss_and_cot, 10)
        cot = loss_and_cot()[None].contiguous()
        bwd = cuda_ms(torch, lambda: st.SIREN_BWD(sp, m.config, mplan, gmode,
                                                  c, cot), 5)
        whole = cuda_ms(torch, lambda: step(s0, c, yt), 5)
        t[tag] = dict(forward=fwd, loss=lms, bwd=bwd, step=whole)
        log(f"phase23 autograd step {tag} ({c.shape[0]} rows, d="
            f"{c.shape[1]}): whole step {whole:.3f} ms = stack forward "
            f"{fwd:.3f} + loss and its gradient {lms:.3f} + C {bwd:.3f} + "
            f"Adam / plateau / best and autograd "
            f"{whole - fwd - lms - bwd:.3f} ms")
        del s0, pred, cot
    # the DSP on the card: the basis matmuls against torch.fft
    sig = torch.from_numpy(clip).to(dev)
    spec = stmdct(sig, n=SPECTRAL_N)
    win = torch.from_numpy(hann_window_periodic(1024)).to(dev)
    mag = stft_magnitude(sig, 1024, 256, win)
    dsp = {}
    for label, fn in (
            ("stmdct", lambda u: stmdct(sig, n=SPECTRAL_N, use_fft=u)),
            ("istmdct", lambda u: istmdct(spec, n=SPECTRAL_N, use_fft=u)),
            ("stft_magnitude", lambda u: stft_magnitude(sig, 1024, 256, win,
                                                        use_fft=u)),
            ("griffin_lim_60", lambda u: griffin_lim(
                mag, 1024, 256, win, length=CLIP_SAMPLES, use_fft=u))):
        iters = 3 if label.startswith("griffin") else 20
        dsp[label] = {u: cuda_ms(torch, lambda u=u: fn(u), iters)
                      for u in (False, True)}
        log(f"phase23 {label} on the card: basis matmul "
            f"{dsp[label][False]:.3f} ms, torch.fft {dsp[label][True]:.3f} "
            f"ms")
    t["dsp"] = dsp
    log(f"phase23 peak device memory of each served fit (MiB): "
        + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items())
        + f"; the grad scratch bound {(st.SCRATCH_BYTES + st.PLANE_BYTES) / 2**20:.0f} MiB "
        f"+ state and rows")
    limit_mib = (st.SCRATCH_BYTES + st.PLANE_BYTES) / 2**20 + 4 * 8 * P / 2**20
    for tag, v in peaks.items():
        if SPECTRAL_FITS[tag][1] == "kan":  # KAN scratch: not this bound
            continue
        rows = 2 * n if SPECTRAL_FITS[tag][0] == "fft" else n
        allowed = limit_mib + 4 * SPECTRAL_ROW_FLOATS * rows / 2**20
        if v > allowed:
            raise AssertionError(f"{tag}: peak {v:.1f} MiB over {allowed:.1f}")
    out["timing"] = t
    return out


def gl_convergence(np, torch, prob, wav):
    """Spectral convergence of a decoded waveform against the fft target's
    magnitude (both peak-normalised)."""
    from inraudio_tpu_torch.dsp import hann_window_periodic, stft_magnitude
    n_fft = prob.decode["n_fft"]
    win = torch.from_numpy(hann_window_periodic(n_fft))
    est = stft_magnitude(torch.from_numpy(wav), n_fft, n_fft // 4, win)
    est = est[:, :prob.width].numpy()
    mag = prob.targets[:, 0].reshape(prob.height, prob.width)
    est = est / max(float(est.max()), 1e-30)
    return float(np.linalg.norm(mag - est) / np.linalg.norm(mag))


class TierTally:
    """D's and E's launches by numerical tier: wraps a fused model's step
    call and ``siren_step.fused_mse_grad_call`` (the sharded step's E) and
    adds each call's rise of the wrappers' own counters to the tier of the
    call's plan ('cheap': the schedule's cheap tier, else 'full')."""

    def __init__(self, ss, model):
        self.ss, self.model = ss, model
        self.counts = {"siren_step": {"cheap": 0, "full": 0},
                       "siren_grad": {"cheap": 0, "full": 0}}
        self.lock = threading.Lock()

    @staticmethod
    def tier(plan, gmode):
        return ("cheap" if gmode == "bf16" and plan.modes[1] == "bf16x2"
                and set(plan.degrees) == {CHEAP_TIER["sin_degree"]}
                else "full")

    def _wrap(self, fn, counter, name):
        def call(*args, **kw):
            with self.lock:
                before = counter.launches
                out = fn(*args, **kw)
                self.counts[name][self.tier(args[11 if name == "siren_step"
                                                 else 6],
                                            args[12 if name == "siren_step"
                                                 else 7])] += (
                    counter.launches - before)
            return out
        return call

    def __enter__(self):
        ctx = self.model.fused_step_ctx
        self._step, self._grad = ctx["step"], self.ss.fused_mse_grad_call
        ctx["step"] = self._wrap(self._step, self.ss.SIREN_STEP,
                                 "siren_step")
        self.ss.fused_mse_grad_call = self._wrap(self._grad,
                                                 self.ss.SIREN_GRAD,
                                                 "siren_grad")
        return self

    def __exit__(self, *exc):
        self.model.fused_step_ctx["step"] = self._step
        self.ss.fused_mse_grad_call = self._grad


def trace_kernel_name(name: str) -> str:
    """A device kernel's name in a profiler trace ("void (anonymous
    namespace)::siren_sweep_kernel<256>(...)") -> its bare name."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.split("::")[-1].strip()


def first_full_round(np, round_losses, targets, db):
    """The JAX fit's escalation rule: the index of the first round on the
    full tier (len(round_losses) when the fit never escalates)."""
    thr = float(np.mean(np.square(targets))) / 10.0 ** (db / 10.0)
    for r, last in enumerate(round_losses):
        if float(last) < thr:
            return r + 1
    return len(round_losses)


def schedule_phases(np, torch, dev, clip):
    """Phases 24-25: the precision schedule at the runner mlp over the
    whole clip.  24: D and E on the cheap tier against their plain
    versions on the same tier beside the 1-ulp control, with the full-tier
    plain versions as the negative control, repeat calls bit-equal, a full
    step after cheap ones bit-equal to a fresh full step, and the timings
    of both tiers; 25: ``fit(precision_schedule=True)`` on one rank and on
    two ranks sharing the card, escalating on the card, against the
    unscheduled fit, and the ``fit --profile`` CLI's trace."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import waveform_fitting
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.tree import tree_leaves, tree_map
    from test_torch_cuda import (GRAD_BF16_BULK_RTOL, GRAD_BF16_MAX_RTOL,
                                 GRAD_BULK_SHARE, LOSS_RTOL, clone_state,
                                 perturb_layer0, run_thread_ranks)

    def bulk(a, b, scale):
        """Share of elements within GRAD_BF16_BULK_RTOL x scale."""
        return float(((a - b).abs() <= GRAD_BF16_BULK_RTOL * scale).float()
                     .mean())

    wav = os.path.join(WORK, "runner_clip.wav")
    problem = waveform_fitting(wav, 7.0)
    x, y = problem.coords, problem.targets
    n = x.shape[0]
    coords = torch.from_numpy(x).to(dev)
    targets = torch.from_numpy(y[:, 0]).to(dev)[None]
    tc = tloop.TrainConfig()  # the runner's defaults: lr 1e-3, no clip
    block = st.tile_rows(RUNNER_H)
    out, fails = {"timing": {}}, []
    if tloop.schedule_tiers()[0] != CHEAP_TIER:
        raise AssertionError(f"schedule_tiers {tloop.schedule_tiers()}")

    # ---- phase 24: the cheap tier on the kernels ----
    for name, rb in runner_shapes(torch, dev).items():
        model = runner_model(rb)
        cfg = model.config
        bt = None if rb is None else sf._prep_rff_bt(rb)
        rff = rb is not None
        plan_c, g_c = ss.tier_plan(cfg, True, rff, CHEAP_TIER)
        plan_f, g_f = ss.tier_plan(cfg, True, rff, None)
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(SEED), tc, dev, windows=1)
        fs0 = ss.flat_state_from_train_state(state, cfg)
        fsu = ss.flat_state_from_train_state(
            state._replace(params=perturb_layer0(state.params)), cfg)
        build = lambda tier, call=ss.fused_mse_step_call: (  # noqa: E731
            ss.make_fused_mse_train_step(cfg, tc, n, approx_sin=True,
                                         step_call=call, rff_b=rb,
                                         tier=tier))
        kc, kf_ = build(CHEAP_TIER), build(None)
        pc, pf = build(CHEAP_TIER, ss.step_plain), build(None, ss.step_plain)
        a1, (la, _) = kc(clone_state(fs0), coords, targets)
        a2, (la2, _) = kc(clone_state(fs0), coords, targets)
        p1, (lp, _) = pc(clone_state(fs0), coords, targets)
        u1, (lu, _) = pc(clone_state(fsu), coords, targets)
        f1, (lf, _) = pf(clone_state(fs0), coords, targets)
        torch.cuda.synchronize()
        gap = lambda a, b: float((a - b).abs().max())  # noqa: E731
        scale = float(p1.mu.abs().max())
        g_err, g_ctl, g_neg = (gap(v.mu, p1.mu) for v in (a1, u1, f1))
        l_err, l_ctl, l_neg = (abs(float(v - lp)) / float(lp)
                               for v in (la, lu, lf))
        g_lim = max(RUNNER_CTRL_X * g_ctl, GRAD_BF16_MAX_RTOL * scale)
        l_lim = max(RUNNER_CTRL_X * l_ctl, LOSS_RTOL)
        neg_g = gap(a1.mu, f1.mu)
        neg_l = abs(float(la - lf)) / float(lf)
        # the bulk rule holds a raw layer 0 (the card tests' rule); an RFF
        # layer 0's 2F-deep sums reorder, so it has the control alone
        share, neg_share = bulk(a1.mu, p1.mu, scale), bulk(a1.mu, f1.mu,
                                                           scale)
        share_min = 0.0 if rff else GRAD_BULK_SHARE
        seen = neg_g > g_lim or neg_l > l_lim or neg_share < share_min
        same = torch.equal(la, la2) and all(torch.equal(p, q)
                                            for p, q in zip(a1, a2))
        ok = (bool(torch.isfinite(a1.params).all()) and g_err <= g_lim
              and l_err <= l_lim and share >= share_min and seen
              and same)
        log(f"phase24 {name} cheap D ({g_c} grads, bf16x2 forward, sin "
            f"degree {CHEAP_TIER['sin_degree']}, "
            f"{'tensor-core' if st.tc_route(plan_c, g_c) else 'FMA'} route) "
            f"vs step_plain on the cheap tier, one step from one state: "
            f"grads (mu) max abs {g_err:.3e} of max {scale:.3e} (limit "
            f"{g_lim:.3e} = max({RUNNER_CTRL_X} x control {g_ctl:.3e}, "
            f"{GRAD_BF16_MAX_RTOL} x max)), {share:.5f} of them within "
            f"{GRAD_BF16_BULK_RTOL} x max (limit >= {share_min}); loss "
            f"rel {l_err:.2e} (control {l_ctl:.2e}, limit {l_lim:.2e}); "
            f"negative control (the cheap kernel against the full-tier plain "
            f"step): grads {neg_g:.3e}, {neg_share:.5f} of them within "
            f"{GRAD_BF16_BULK_RTOL} x max, loss rel {neg_l:.2e}, beyond a "
            f"limit {'yes' if seen else 'NO'}, {neg_g / max(g_err, 1e-30):.0f}"
            f" x the kernel's gap (full-tier plain vs cheap plain: "
            f"grads {g_neg:.3e}, loss rel {l_neg:.2e}); repeat bit-equal "
            f"{same}; {'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"{name} cheap D")
        out[(name, "step_err")] = g_err
        # a full step after cheap ones is a fresh full step on that carry
        c = clone_state(fs0)
        for _ in range(2):
            c, _ = kc(c, coords, targets)
        fresh, (l_fresh, _) = build(None)(clone_state(c), coords, targets)
        c, (l_full, _) = kf_(c, coords, targets)
        torch.cuda.synchronize()
        switch = torch.equal(l_full, l_fresh) and all(
            torch.equal(p, q) for p, q in zip(c, fresh))
        log(f"phase24 {name} two cheap steps then a full step on one carry "
            f"vs a fresh full step on a copy: bit-equal {switch}")
        if not switch:
            fails.append(f"{name} tier switch")
        del a2, p1, u1, f1, c, fresh
        # E on one shard of two, the cheap tier against its plain version
        cs, ts, limit, sh = _shard_inputs(torch, np, dev, x, y, 0, 2, block)
        eargs = (cs, ts, limit, n, cfg)
        P = a1.params.shape[1]
        kb = ss.SIREN_GRAD(a1.params, *eargs, plan_c, g_c, bt)
        kb2 = ss.SIREN_GRAD(a1.params, *eargs, plan_c, g_c, bt)
        pb = ss.grad_plain(a1.params, *eargs, plan_c, g_c, bt)
        pert = st.flatten_params(perturb_layer0(st.unflatten_params(
            a1.params, cfg)), cfg)
        cb = ss.grad_plain(pert, *eargs, plan_c, g_c, bt)
        fb = ss.grad_plain(a1.params, *eargs, plan_f, g_f, bt)
        torch.cuda.synchronize()
        escale = float(pb[:P].abs().max())
        e_err, e_ctl = gap(kb[:P], pb[:P]), gap(cb[:P], pb[:P])
        el_err = abs(float(kb[P] - pb[P])) / float(pb[P])
        el_ctl = abs(float(cb[P] - pb[P])) / float(pb[P])
        e_lim = max(RUNNER_CTRL_X * e_ctl, GRAD_BF16_MAX_RTOL * escale)
        el_lim = max(RUNNER_CTRL_X * el_ctl, LOSS_RTOL)
        e_neg = gap(kb[:P], fb[:P])
        el_neg = abs(float(kb[P] - fb[P])) / float(fb[P])
        e_share = bulk(kb[:P], pb[:P], escale)
        e_neg_share = bulk(kb[:P], fb[:P], escale)
        e_seen = (e_neg > e_lim or el_neg > el_lim
                  or e_neg_share < share_min)
        e_same = torch.equal(kb, kb2)
        ok = (bool(torch.isfinite(kb).all()) and e_err <= e_lim
              and el_err <= el_lim and e_share >= share_min
              and e_seen and e_same)
        log(f"phase24 {name} cheap E on shard 0 ({sh.rows} rows) vs "
            f"grad_plain on the cheap tier: grads max abs {e_err:.3e} of "
            f"max {escale:.3e} (limit {e_lim:.3e} = max({RUNNER_CTRL_X} x "
            f"control {e_ctl:.3e}, {GRAD_BF16_MAX_RTOL} x max)), "
            f"{e_share:.5f} within {GRAD_BF16_BULK_RTOL} x max (limit >= "
            f"{share_min}); loss rel {el_err:.2e} (control "
            f"{el_ctl:.2e}, limit {el_lim:.2e}); negative control (full-tier "
            f"grad_plain): grads {e_neg:.3e}, {e_neg_share:.5f} within "
            f"{GRAD_BF16_BULK_RTOL} x max, loss rel {el_neg:.2e}, beyond a "
            f"limit {'yes' if e_seen else 'NO'}, "
            f"{e_neg / max(e_err, 1e-30):.0f} x the kernel's gap; repeat "
            f"bit-equal {e_same}; "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"{name} cheap E")
        out[(name, "grad_err")] = e_err
        del kb2, pb, cb, fb
        # timings, CUDA events: both tiers' step, sweep split and E
        t = {}
        fs = a1
        for tier, (plan, gm, ks, ps) in {
                "cheap": (plan_c, g_c, kc, pc),
                "full": (plan_f, g_f, kf_, pf)}.items():
            t[f"step_{tier}"] = cuda_ms(torch, lambda: ks(fs, coords,
                                                         targets), 10)
            t[f"step_{tier}_plain"] = cuda_ms(torch, lambda: ps(
                fs, coords, targets), 2)
            g = st.validate_grad_launch(fs.params, cfg, plan, coords, bt)
            t[f"split_{tier}"] = tc_split_ms(torch, st, g, coords,
                                             fs.params, 10, targets=targets,
                                             gmode=gm)
            t[f"grad_{tier}"] = cuda_ms(torch, lambda: ss.SIREN_GRAD(
                fs.params, *eargs, plan, gm, bt), 10)
            t[f"grad_{tier}_plain"] = cuda_ms(torch, lambda: ss.grad_plain(
                fs.params, *eargs, plan, gm, bt), 2)
        t["step_cheap2"] = cuda_ms(torch, lambda: kc(fs, coords, targets),
                                   10)
        n_params = sum(v.numel() for p in state.params["layers"]
                       for v in p.values())
        n_freq = 0 if bt is None else bt.shape[1]
        for tier, (fp, gp) in {"cheap": (2, 1), "full": (3, 2)}.items():
            _, step_b, _ = siren_bounds(1, n, RUNNER_H, n_params, n_freq,
                                        fwd_passes=fp, grad_passes=gp)
            grad_b = siren_bounds(1, sh.rows, RUNNER_H, n_params, n_freq,
                                  fwd_passes=fp, grad_passes=gp)[2]
            t[f"step_{tier}_bound"], t[f"grad_{tier}_bound"] = step_b, grad_b
        cheap_ms = min(t["step_cheap"], t["step_cheap2"])
        log(f"phase24 {name} timings: D step cheap {t['step_cheap']:.3f} / "
            f"{t['step_cheap2']:.3f} ms against full {t['step_full']:.3f} ms "
            f"({100 * (cheap_ms / t['step_full'] - 1):+.2f}%); plain step "
            f"cheap {t['step_cheap_plain']:.3f}, full "
            f"{t['step_full_plain']:.3f} ms; bound cheap "
            f"{t['step_cheap_bound'][0]:.3f} ms ({t['step_cheap_bound'][1]}),"
            f" full {t['step_full_bound'][0]:.3f} ms; sweep cheap "
            f"{t['split_cheap']['siren_sweep']:.3f} / full "
            f"{t['split_full']['siren_sweep']:.3f} ms, dW "
            f"{t['split_cheap']['siren_dw']:.3f} / "
            f"{t['split_full']['siren_dw']:.3f}, weight split "
            f"{t['split_cheap']['siren_wsplit']:.3f} / "
            f"{t['split_full']['siren_wsplit']:.3f}, reduce "
            f"{t['split_cheap']['siren_reduce']:.3f} / "
            f"{t['split_full']['siren_reduce']:.3f}; E on shard 0 cheap "
            f"{t['grad_cheap']:.3f} / full {t['grad_full']:.3f} ms "
            f"({100 * (t['grad_cheap'] / t['grad_full'] - 1):+.2f}%), plain "
            f"{t['grad_cheap_plain']:.3f} / {t['grad_full_plain']:.3f}, "
            f"bound {t['grad_cheap_bound'][0]:.3f} / "
            f"{t['grad_full_bound'][0]:.3f} ms")
        out["timing"][name] = t
        del a1, fs, kb
    if fails:
        raise AssertionError(f"phase 24 failed: {fails}")

    # ---- phase 25: the schedule through fit, and the profiler ----
    model = runner_model(None)
    s0 = tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                tc, dev)
    steps, chunk = SCHEDULE_STEPS, SCHEDULE_CHUNK
    rounds = steps // chunk
    base = dataclasses.replace(tc, total_steps=steps, scan_chunk=chunk)
    counters = launch_counters()
    fits = {}

    def run(label, cfg_, mesh_ranks=0):
        for cnt in counters.values():
            cnt.launches = 0
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with TierTally(ss, model) as tally:
            if mesh_ranks:
                res = run_thread_ranks(mesh_ranks, lambda m: tloop.fit(
                    model, x, y, cfg_, state=s0, mesh=m), device=dev)
            else:
                res = [tloop.fit(model, x, y, cfg_, state=s0, device=dev)]
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**20
        fits[label] = dict(res=res, tally=tally.counts, peak=peak,
                           launches={k: c.launches
                                     for k, c in counters.items()})
        return res

    ref = run("unscheduled", base)[0]
    hist = ref.loss_history
    # a floor between the losses at the ends of the first and the second
    # round, so that the escalation falls mid-fit on the card
    mid = float(np.sqrt(float(hist[chunk - 1]) * float(hist[2 * chunk - 1])))
    db = float(10.0 * np.log10(float(np.mean(np.square(y))) / mid))
    run("schedule_45dB", dataclasses.replace(base, precision_schedule=True))
    run("schedule_low", dataclasses.replace(base, precision_schedule=True,
                                            schedule_db=db))
    run("schedule_low_2ranks", dataclasses.replace(
        base, precision_schedule=True, schedule_db=db), mesh_ranks=2)
    for label, f in fits.items():
        res = f["res"]
        r0 = res[0]
        db_ = {"schedule_45dB": 45.0}.get(label, db)
        ranks = len(res)
        ends = r0.loss_history[chunk - 1::chunk]
        want = (rounds if label == "unscheduled"
                else first_full_round(np, ends, y, db_))
        cheap_steps = 0 if label == "unscheduled" else chunk * want
        kernel = "siren_grad" if ranks > 1 else "siren_step"
        tally = f["tally"][kernel]
        expect = {"cheap": ranks * cheap_steps,
                  "full": ranks * (steps - cheap_steps)}
        same = ranks == 1 or (
            np.array_equal(res[0].loss_history, res[1].loss_history)
            and all(torch.equal(p, q) for p, q in zip(
                tree_leaves(res[0].state), tree_leaves(res[1].state))))
        total_ok = f["launches"][kernel] == ranks * steps
        ok = tally == expect and same and total_ok and bool(
            np.isfinite(r0.loss_history).all())
        escal = ("never" if want >= rounds else f"at round {want}")
        log(f"phase25 fit {label} ({ranks} rank{'s' if ranks > 1 else ''}, "
            f"{steps} steps in rounds of {chunk}, schedule_db {db_:.4f}): "
            f"round-end losses {[float(v) for v in ends]}; the rule "
            f"(floor {float(np.mean(np.square(y))) / 10 ** (db_ / 10):.9g}) "
            f"gives the full tier {escal}; "
            f"{'D' if ranks == 1 else 'E'} launches by tier {tally} "
            f"(expected {expect}), all launches {f['launches']}; ranks "
            f"equal {same}; {r0.steps_per_sec:.2f} steps/s; peak device "
            f"memory {f['peak']:.1f} MiB; {'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(f"schedule fit {label}")
    if first_full_round(np, fits["schedule_low"]["res"][0].loss_history[
            chunk - 1::chunk], y, db) >= rounds:
        fails.append("the low-floor fit did not escalate on the card")
    out["fits"] = {k: dict(steps_s=v["res"][0].steps_per_sec,
                           tally=v["tally"], peak=v["peak"])
                   for k, v in fits.items()}
    out["launches_cheap"] = {
        "siren_step": (fits["schedule_45dB"]["tally"]["siren_step"]["cheap"]
                       + fits["schedule_low"]["tally"]["siren_step"]
                       ["cheap"]),
        "siren_grad": fits["schedule_low_2ranks"]["tally"]["siren_grad"]
        ["cheap"]}
    del fits
    # the profiler through the CLI
    tag = "mlp_profile"
    rec, _ = run_cli_fit(cli_main, "phase25", wav, tag, "mlp",
                         PROFILE_STEPS, ["--profile"])
    trace_dir = os.path.join(WORK, tag, "trace")
    names = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    kernels_seen = {}
    for fname in names:
        with open(os.path.join(trace_dir, fname)) as fh:
            events = json.load(fh).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel":
                k = trace_kernel_name(e.get("name", ""))
                kernels_seen[k] = kernels_seen.get(k, 0) + 1
    ok = bool(names) and any("siren_sweep_kernel" in k for k in kernels_seen)
    log(f"phase25 CLI fit --fused --profile --no-plots, {PROFILE_STEPS} "
        f"steps (one round, the profiled one): trace files {names}; device "
        f"kernels in the trace {dict(sorted(kernels_seen.items()))}; "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fails.append("profile trace")
    out["params"] = ref.params
    if fails:
        raise AssertionError(f"phase 25 failed: {fails}")
    return out


def zoo_phases(np, torch, dev, clip, trained_params):
    """Phase 26: the zoo and the runner's tail on the card: the classic
    SIREN and the ReLU MLP at their configs' defaults fitted over the whole
    clip, the scaled-first mlp through the CLI, ``random_plane`` on the
    trained runner mlp (B's launches counted), the decimation curriculum
    and the band split, and the plots where matplotlib is present; each
    with its rate and peak device memory."""
    from inraudio_tpu_torch.__main__ import main as cli_main
    from inraudio_tpu_torch.data import waveform_fitting
    from inraudio_tpu_torch.experiments import (band_split_train,
                                                procedural_train)
    from inraudio_tpu_torch.models import build_model
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.losses import mix_loss
    from inraudio_tpu_torch.utils.landscape import random_plane

    wav = os.path.join(WORK, "runner_clip.wav")
    problem = waveform_fitting(wav, 7.0)
    x, y = problem.coords, problem.targets
    fails, out = [], {}

    def measured(fn):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - mem0) / 2**20)

    # ---- phase 26: the zoo and the runner's tail ----
    for arch in ("siren", "relu"):
        model = build_model(arch)
        tc = tloop.TrainConfig(total_steps=ZOO_STEPS, scan_chunk=ZOO_STEPS)
        r, wall, peak = measured(lambda: tloop.fit(
            model, x, y, tc, generator=torch.Generator().manual_seed(SEED),
            device=dev))
        ok = (bool(np.isfinite(r.loss_history).all())
              and r.best_loss < float(r.loss_history[0]))
        log(f"phase26 {arch} {model.config} over {x.shape[0]} rows, "
            f"{ZOO_STEPS} steps (autograd, fp32 cuBLAS products, TF32 off):"
            f" loss {float(r.loss_history[0]):.6g} -> "
            f"{float(r.loss_history[-1]):.6g}, {r.steps_per_sec:.2f} "
            f"steps/s, {wall:.2f} s, peak device memory {peak:.1f} MiB; "
            f"{'ok' if ok else 'FAILED'}")
        out[arch] = dict(steps_s=r.steps_per_sec, peak=peak)
        if not ok:
            fails.append(f"zoo {arch}")
    (rec, _), wall, peak = measured(lambda: run_cli_fit(
        cli_main, "phase26", wav, "mlp_scaled_first", "mlp", ZOO_STEPS,
        ["--scaled-first"], fused=False))
    ok = rec["scaled_first"] is True and np.isfinite(rec["best_loss"])
    log(f"phase26 scaled-first mlp (unfused, autograd): {wall:.2f} s, "
        f"peak device memory {peak:.1f} MiB; {'ok' if ok else 'FAILED'}")
    out["scaled_first"] = dict(steps_s=rec["steps_per_sec"], peak=peak)
    if not ok:
        fails.append("scaled-first CLI")
    # the landscape on the trained runner mlp, B counted
    model = runner_model(None)
    coords = torch.from_numpy(x).to(dev)
    targets = torch.from_numpy(y).to(dev)
    sf.SIREN_STACK.launches = 0
    surf, wall, peak = measured(lambda: random_plane(
        lambda p: mix_loss(model.apply(p, coords), targets, loss_mode="mse"),
        trained_params, torch.Generator().manual_seed(SEED + (1 << 32)),
        distance=2.0, steps=LANDSCAPE_STEPS))
    launches = sf.SIREN_STACK.launches
    ok = (surf.shape == (LANDSCAPE_STEPS, LANDSCAPE_STEPS)
          and bool(np.isfinite(surf).all())
          and launches == LANDSCAPE_STEPS ** 2)
    log(f"phase26 random_plane {LANDSCAPE_STEPS} x {LANDSCAPE_STEPS}, "
        f"distance 2, on the trained runner mlp over {x.shape[0]} rows: "
        f"{wall:.2f} s ({1e3 * wall / LANDSCAPE_STEPS ** 2:.3f} ms a point)"
        f", peak device memory {peak:.1f} MiB; B launches {launches} "
        f"(expected {LANDSCAPE_STEPS ** 2}); loss range "
        f"[{float(surf.min()):.6g}, {float(surf.max()):.6g}]; "
        f"{'ok' if ok else 'FAILED'}")
    out["landscape"] = dict(s=wall, peak=peak, launches=launches)
    if not ok:
        fails.append("landscape")
    # the pipelines through the runner (fused mlp, the CLI defaults)
    pdir = os.path.join(WORK, "pipelines")
    kw = dict(total_steps=PIPELINE_STEPS, fused=True, make_plots=False,
              device=dev)
    ck, wall, peak = measured(lambda: procedural_train(
        pdir, "proc", filename=wav, duration=7.0, **kw))
    recs = []
    for d in (8, 4, 2, 1):
        with open(os.path.join(pdir, f"proc_d{d}", "parameters.json")) as fh:
            recs.append(json.load(fh))
    ok = (ck == os.path.join(pdir, "proc_d1", "saved_ckpt.npz")
          and [r["decimation"] for r in recs] == [8, 4, 2, 1])
    log(f"phase26 procedural_train d8 -> d4 -> d2 -> d1, {PIPELINE_STEPS} "
        f"steps each: {wall:.2f} s, steps/s "
        f"{[round(r['steps_per_sec'], 2) for r in recs]}, SNR "
        f"{[round(r['SNR'], 3) for r in recs]} dB, peak device memory "
        f"{peak:.1f} MiB; {'ok' if ok else 'FAILED'}")
    out["procedural"] = dict(s=wall, peak=peak,
                             steps_s=[r["steps_per_sec"] for r in recs])
    if not ok:
        fails.append("procedural_train")
    res, wall, peak = measured(lambda: band_split_train(
        pdir, "band", clip, FS, **kw))
    ok = bool(np.isfinite(res["rec"]).all()) and np.isfinite(res["snr"])
    log(f"phase26 band_split_train at 10 kHz (order-5 Butterworth, float64 "
        f"on the host), {PIPELINE_STEPS} steps a band: {wall:.2f} s, "
        f"steps/s lp {res['lp']['record']['steps_per_sec']:.2f} / hp "
        f"{res['hp']['record']['steps_per_sec']:.2f}, summed SNR "
        f"{res['snr']:.3f} dB, peak device memory {peak:.1f} MiB; "
        f"{'ok' if ok else 'FAILED'}")
    out["band_split"] = dict(s=wall, peak=peak)
    if not ok:
        fails.append("band_split_train")
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    if have_mpl:
        tag = "mlp_plots"
        run_cli_fit(cli_main, "phase26", wav, tag, "mlp", PIPELINE_STEPS,
                    ["--visualization"], plots=True)
        pngs = sorted(f for f in os.listdir(os.path.join(WORK, tag))
                      if f.endswith(".png"))
        ok = set(pngs) >= {"loss.png", "spec_ref.png", "spec.png",
                           "wave.png", "landscape.png"}
        log(f"phase26 plots and --visualization: {pngs}; "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append("plots")
    else:
        log("phase26 matplotlib is not installed on this machine: the plots "
            "and --visualization's PNG are tested on the CPU only "
            "(tests/test_torch_experiment_tail.py)")
    if fails:
        raise AssertionError(f"phase 26 failed: {fails}")
    return out


# ---------------------------------------------------------------------------
# Phases 27-29: the whole-signal losses on a mesh, a window population's
# other losses, and G and H at grid extension's sizes and orders up to 8
# ---------------------------------------------------------------------------

def whole_signal_split(torch, model, tc, mesh, x, y, weight, reps=5):
    """Rank ``mesh.rank``'s wall ms of each part of the sharded step of a
    loss that needs the whole signal: ``train.loop.make_sharded_train_step``
    with a synchronise after each part (its ``mark``): its shard's forward,
    the all-gather of the prediction, the loss of the whole clip with its
    cotangent, the shard's backward, the all-reduce of the gradients and
    the update (clip, Adam, plateau, best); the mean over ``reps`` steps
    after a warm-up."""
    from inraudio_tpu_torch.train import loop as tloop
    marks = []

    def mark(part):
        torch.cuda.synchronize()
        marks.append((part, time.perf_counter()))

    step = tloop.make_sharded_train_step(model, tc, mesh, x, y, weight,
                                         mark=mark)
    state = tloop_init(torch, model, tc, mesh.device)
    total = {}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        marks[:] = [("start", time.perf_counter())]
        state, _ = step(state)
        mark("update")
        if rep:
            for (_, a), (part, b) in zip(marks, marks[1:]):
                total[part] = total.get(part, 0.0) + (b - a) * 1e3 / reps
    return total


def tloop_init(torch, model, tc, dev):
    from inraudio_tpu_torch.train import loop as tloop
    return tloop.init_train_state(model, torch.Generator().manual_seed(SEED),
                                  tc, dev)


def mesh_loss_phases(np, torch, dev, clip):
    """Phase 27: the losses that need the whole signal, on two thread ranks
    sharing the card (gloo), at full width: each fit against the same fit
    on one rank beside its 1-ulp control, the ranks bit-equal, the launches
    counted, and the sharded step's parts."""
    from inraudio_tpu_torch.data import waveform_fitting, write_wav
    from inraudio_tpu_torch.experiments import runner as trunner
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.tree import tree_leaves, tree_map
    from test_torch_cuda import LOSS_RTOL, run_thread_ranks

    # an even clip: the two ranks' gathered clip is then the one rank's
    # clip (an odd one is padded by a zero row in both packages, whose
    # STFT frames differ; tests/test_torch_whole_signal.py holds that case
    # to the JAX package)
    wav = os.path.join(WORK, "mesh_clip.wav")
    write_wav(wav, FS, clip[:CLIP_SAMPLES - CLIP_SAMPLES % 2])
    wave = waveform_fitting(wav, 7.0)
    mdct = trunner.build_problem("mdct", wav, 7.0, n=SPECTRAL_N,
                                 perceptual_mask=True, device=dev)
    counters = launch_counters()
    out, fails = {"launches": {}, "split": {}}, []
    for tag, (method, arch, kw) in MESH_LOSS_FITS.items():
        prob = wave if method == "wave" else mdct
        x, y = prob.coords, prob.targets
        weight = prob.loss_weight if method == "mdct" else None
        model = spectral_model(arch, x.shape[1])
        tc = tloop.TrainConfig(total_steps=MESH_LOSS_STEPS,
                               scan_chunk=MESH_LOSS_STEPS, **kw)
        s0 = tloop_init(torch, model, tc, dev)
        one = tloop.fit(model, x, y, tc, state=tree_map(torch.clone, s0),
                        device=dev, weight=weight)
        ulp = tloop.fit(model, x, y, tc, device=dev, weight=weight,
                        state=s0._replace(params=tree_map(
                            lambda t: t * (1.0 + 2.0 ** -22), s0.params)))
        for c in counters.values():
            c.launches = 0
        res = run_thread_ranks(2, lambda m: tloop.fit(
            model, x, y, tc, state=s0, mesh=m, weight=weight), device=dev)
        cnt = {k: c.launches for k, c in counters.items() if c.launches}
        out["launches"][tag] = cnt
        l1, lk, lu = (float(one.loss_history[0]), float(one.loss_history[-1]),
                      float(ulp.loss_history[-1]))
        l1s, ls = (float(res[0].loss_history[0]),
                   float(res[0].loss_history[-1]))
        limit = max(KAN_CMP_CONTROL_X * abs(lk - lu),
                    KAN_CMP_FLOOR_REL * abs(lk),
                    SNR_FLOOR_DB if tc.loss_mode == "snr" else 0.0)
        first = LOSS_RTOL * max(abs(l1), 1.0)
        same = (all(torch.equal(p, q) for p, q in zip(
            tree_leaves(res[0].state), tree_leaves(res[1].state)))
            and np.array_equal(res[0].loss_history, res[1].loss_history))
        fwd, bwd = (("kan_fwd", "kan_bwd") if arch == "kan"
                    else ("siren_stack", "siren_bwd"))
        ok = (abs(l1s - l1) <= first and abs(ls - lk) <= limit and same
              and np.isfinite(res[0].loss_history).all()
              and cnt.get(fwd) == 2 * MESH_LOSS_STEPS
              and cnt.get(bwd) == 2 * MESH_LOSS_STEPS
              and not cnt.get("siren_step") and not cnt.get("siren_grad"))
        split = run_thread_ranks(2, lambda m: whole_signal_split(
            torch, model, tc, m, x, y, weight), device=dev)[0]
        out["split"][tag] = split
        out[tag] = dict(steps_s=res[0].steps_per_sec,
                        one_steps_s=one.steps_per_sec)
        log(f"phase27 {tag} ({method}, {arch}, {kw}, {x.shape[0]} rows, "
            f"weight {'mask' if weight is not None else 'none'}) "
            f"fit(mesh=2 ranks on one card, gloo), {MESH_LOSS_STEPS} steps: "
            f"first loss {l1s:.9g} vs one rank {l1:.9g} (|diff| "
            f"{abs(l1s - l1):.3e}, limit {first:.3e}); final loss sharded "
            f"{ls:.9g} / one rank {lk:.9g} / perturbed one rank {lu:.9g}, "
            f"gated |sharded - one| {abs(ls - lk):.3e} (limit {limit:.3e}); "
            f"ranks bit-equal {same}; launches {cnt}; steps/s sharded "
            f"{res[0].steps_per_sec:.2f} ({1e3 / res[0].steps_per_sec:.3f} "
            f"ms a step), one rank {one.steps_per_sec:.2f} "
            f"({1e3 / one.steps_per_sec:.3f} ms); rank 0's step parts (ms, "
            f"host clock, synchronised): " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items())
            + f"; {'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(tag)
        del one, ulp, res
    if fails:
        raise AssertionError(f"phase 27 failed: {fails}")
    return out


def permute_hidden(params, q):
    """An mlp's params (one model or a population) with every hidden
    layer's units in the order ``q``: the same function, its sums over
    hidden units taken in another order.  Applied to gradients with
    ``argsort(q)`` it puts them back."""
    layers, last = [], len(params["layers"]) - 1
    for li, p in enumerate(params["layers"]):
        p = dict(p)
        if li > 0:
            p["w"] = p["w"][..., q, :]
        if li < last:
            p["w"] = p["w"][..., :, q]
            for key in ("b", "snake_a"):
                if key in p:
                    p[key] = p[key][..., q]
        layers.append(p)
    return {"layers": layers}


def population_phases(np, torch, dev, clip):
    """Phase 28: a window population's other losses (``make_train_step``,
    every window's own ``mix_loss``) through the stack kernel (A) and
    kernel C: the losses against the plain forward's beside a 1-ulp
    control, C on the step's cotangent against its plain version, the
    launches of POP_STEPS steps, timings; and the 512-row windows that the
    STFT term refuses."""
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.train import loop as tloop
    from inraudio_tpu_torch.train.losses import mix_loss
    from test_torch_cuda import check_grads, perturb_layer0

    counters = launch_counters()
    gmode = st.grad_dot_mode()
    out, fails = {}, []
    for tag, (shape, kw) in POP_CASES.items():
        cfg, model, tc0, coords, targets = train_population(
            np, torch, dev, clip, shape, SHAPES[shape])
        tc = dataclasses.replace(tc0, **kw)
        k, n = targets.shape
        t3 = targets[..., None].contiguous()
        state = tloop.init_train_state(
            model, torch.Generator().manual_seed(SEED), tc, dev, windows=k)
        plan = sf.stack_plan(cfg, approx_sin=True)
        step = tloop.make_train_step(model, tc)

        def loss_of(pred):
            return mix_loss(pred, t3, loss_mode=tc.loss_mode, alpha=tc.alpha,
                            multi_resolution=tc.multi_resolution_stft,
                            windows=True)

        for c in counters.values():
            c.launches = 0
        s = state
        for i in range(POP_STEPS):
            s, (loss, _) = step(s, coords, t3)
            if i == 0:
                loss0 = loss.clone()
        torch.cuda.synchronize()
        cnt = {name: c.launches for name, c in counters.items()
               if c.launches}
        ref = loss_of(sf.stack_forward_plain(state.params, plan, coords))
        ctl = loss_of(sf.stack_forward_plain(perturb_layer0(state.params),
                                             plan, coords))
        gap, cgap = (float((a - ref).abs().max()) for a in (loss0, ctl))
        limit = max(KAN_CMP_CONTROL_X * cgap,
                    KAN_CMP_FLOOR_REL * float(ref.abs().max()))
        pred = st.fused_siren_train_apply(state.params, cfg, coords,
                                          approx_sin=True).detach()
        pred.requires_grad_(True)
        (cot,) = torch.autograd.grad(loss_of(pred).sum(), pred)
        # C on the step's cotangent against its plain version, in the step's
        # grad tier and in the highest: within the tier's rule
        # (check_grads), or within POP_ORDER_X times the plain version's own
        # gap to itself with its sums in another order (the rows and the
        # hidden units permuted, seeded), a limit that must resolve
        # POP_RESOLVE of the gradient.  The plain backward with layer 0 one
        # ulp off is printed beside it.
        gen = torch.Generator().manual_seed(SEED)
        rows = torch.randperm(n, generator=gen).to(dev)
        units = torch.randperm(cfg.hidden_features, generator=gen).to(dev)
        gok, gdesc = bool(torch.isfinite(loss0).all()), []
        for tier in dict.fromkeys((gmode, "highest")):
            gk = st.flatten_params(st.SIREN_BWD(
                state.params, cfg, plan, tier, coords, cot), cfg)
            gp, gc = (st.flatten_params(st.backward_plain(
                p, plan, tier, coords, cot), cfg)
                for p in (state.params, perturb_layer0(state.params)))
            gq = st.flatten_params(permute_hidden(st.backward_plain(
                permute_hidden(state.params, units), plan, tier,
                coords[rows], cot[:, rows]), torch.argsort(units)), cfg)
            torch.cuda.synchronize()
            diff = (gk - gp).abs()
            gerr, scale = float(diff.max()), float(gp.abs().max())
            bulk = float((diff <= 1e-3 * scale).float().mean())
            order_gap = float((gq - gp).abs().max())
            ulp_gap = float((gc - gp).abs().max())
            glimit = POP_ORDER_X * order_gap
            try:
                check_grads(gk, gp, tier)
                rule = "within"
            except AssertionError:
                rule = "beyond"
            t_ok = (bool(torch.isfinite(gk).all()) and (
                rule == "within"
                or (gerr <= glimit and glimit <= POP_RESOLVE * scale)))
            gok = gok and t_ok
            gdesc.append(
                f"{tier}: max abs {gerr:.3e} ({rule} the tier's rule; "
                f"limit {glimit:.3e} = {POP_ORDER_X} x the plain version's "
                f"gap to itself with rows and hidden units permuted "
                f"{order_gap:.3e}; max "
                f"|grad| {scale:.3e}; layer 0 one ulp off moves it "
                f"{ulp_gap:.3e}; {bulk:.2%} of the entries within 1e-3 of "
                f"max |grad|) {'ok' if t_ok else 'FAILED'}")
            if tier == gmode:
                out_err = gerr
            del gk, gp, gq, gc, diff

        def plain_step():
            p = sf.stack_forward_plain(state.params, plan, coords)
            p.requires_grad_(True)
            (c,) = torch.autograd.grad(loss_of(p).sum(), p)
            return st.backward_plain(state.params, plan, gmode, coords, c)

        ms = cuda_ms(torch, lambda: step(state, coords, t3), 5)
        plain_ms = cuda_ms(torch, plain_step, 2)
        ok = (gap <= limit and gok
              and cnt.get("siren_stack") == POP_STEPS
              and cnt.get("siren_bwd") == POP_STEPS
              and not cnt.get("siren_step"))
        out[tag] = dict(ms=ms, plain_ms=plain_ms, launches=cnt, err=out_err)
        log(f"phase28 {tag}: {k} windows of {n} rows, h={cfg.hidden_features}"
            f", {kw}: {POP_STEPS} steps launched {cnt}; first losses vs the "
            f"plain forward's max |diff| {gap:.3e} (limit {limit:.3e}, "
            f"control {cgap:.3e}); C on the step's cotangent vs its plain "
            f"version, " + "; ".join(gdesc) + "; step "
            f"{ms:.3f} ms (A + loss + C + Adam, CUDA events), plain forward "
            f"+ loss + backward {plain_ms:.3f} ms; "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(tag)
        if shape == "headline":
            try:
                tloop.make_train_step(model, dataclasses.replace(
                    tc, alpha=0.5))(state, coords, t3)
                fails.append("512-row windows took the STFT term")
            except ValueError as e:
                log(f"phase28 headline windows ({n} rows) with alpha 0.5: "
                    f"ValueError as in the JAX package ({e})")
        del state, s, pred, cot
    if fails:
        raise AssertionError(f"phase 28 failed: {fails}")
    return out


def kan_library_ab(torch, dev, iters=10):
    """G and H of the runner KAN (grid 5, order 3) over the whole clip
    through the default build of kan.cu and through the wide one
    (``kan_fused.is_wide`` forced), timed in the order default, wide, wide,
    default: {library: [(G ms, H ms), ...]} and the largest gap between
    the two libraries' outputs and gradients."""
    from inraudio_tpu_torch.models import KANConfig, build_model
    from inraudio_tpu_torch.ops import kan_fused as kf
    cfg = KANConfig(layers_hidden=KAN_LAYERS)
    params = build_model("kan", cfg, fused=True).init(
        torch.Generator().manual_seed(SEED), dev)
    flat = [t.detach().contiguous() for t in kf.flatten_kan_params(params)]
    layers = list(zip(flat[0::2], flat[1::2]))
    mode, order, n = kf.kan_dot_mode(), cfg.spline_order, CLIP_SAMPLES
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    g = torch.ones((n, 1), device=dev) / n
    is_wide = kf.is_wide
    times, outs = {"default": [], "wide": []}, {}
    try:
        for lib in ("default", "wide", "wide", "default"):
            kf.is_wide = (lambda o, nk: True) if lib == "wide" else is_wide
            out, xs = kf.KAN_FWD(layers, coords, order, mode)
            outs[lib] = [out] + kf.KAN_BWD(layers, xs, g, order, mode)
            times[lib].append((
                cuda_ms(torch, lambda: kf.KAN_FWD(layers, coords, order,
                                                  mode), iters),
                cuda_ms(torch, lambda: kf.KAN_BWD(layers, xs, g, order,
                                                  mode), iters)))
            del out, xs
    finally:
        kf.is_wide = is_wide
    gap = max(float((a - b).abs().max())
              for a, b in zip(outs["default"], outs["wide"]))
    return times, gap


class _EntryLog:
    """A kan.cu library that records the names of the C entries called
    through it (``called``)."""

    def __init__(self, lib):
        self._lib, self.called = lib, set()

    def __getattr__(self, name):
        self.called.add(name)
        return getattr(self._lib, name)


def kan_order_phases(np, torch, dev, clip):
    """Phase 29: G and H at the runner KAN's widths with grid extension's
    sizes and orders up to 8 (the wide library), after the runner's grid 5
    / order 3 timed through both builds of kan.cu: G and H against their
    plain versions on a row subset (the plain bases at grid 100 over the
    whole clip would take tens of GB), two calls bit-equal, the same after
    an ``update_grid`` refresh; fits over the whole clip served through
    ``fit`` with the launches counted (the grid 20 fit refreshes its grid
    every 10 steps); per-layer and whole-stack timings against the plain
    versions and the bounds."""
    from inraudio_tpu_torch.data import waveform_fitting, write_wav
    from inraudio_tpu_torch.models import KANConfig, build_model
    from inraudio_tpu_torch.ops import kan_fused as kf
    from inraudio_tpu_torch.train import loop as tloop
    from test_torch_cuda import (KAN_GRAD_RTOL, check_kan,
                                 check_kan_outputs)

    wav = os.path.join(WORK, "kan_order_clip.wav")
    write_wav(wav, FS, clip)
    prob = waveform_fitting(wav, 7.0)
    x, y = prob.coords, prob.targets
    n = x.shape[0]
    coords = torch.from_numpy(x).to(dev)
    sub = coords[::-(-n // KAN_SUBSET_ROWS)].contiguous()
    tsub = torch.from_numpy(y[::-(-n // KAN_SUBSET_ROWS)]).to(dev)
    mode = kf.kan_dot_mode()
    out, fails = {}, []
    # the default build against the wide one at the runner's grid 5 / order
    # 3, which both take: what keeping the default build buys
    ab, ab_gap = kan_library_ab(torch, dev)
    log(f"phase29 runner KAN{KAN_LAYERS} grid 5 order 3 over {CLIP_SAMPLES}"
        f" rows through each build of kan.cu (CUDA events, in the order "
        f"default, wide, wide, default): " + "; ".join(
            f"{lib} G " + "/".join(f"{g:.3f}" for g, _ in t) + " ms, H "
            + "/".join(f"{h:.3f}" for _, h in t) + " ms"
            for lib, t in ab.items())
        + f"; the builds' outputs and gradients max |diff| {ab_gap:.3e}")
    if not ab_gap == 0.0:
        fails.append("the two builds of kan.cu disagree at grid 5 order 3")
    for grid_size, order, steps, every in KAN_ORDER_CASES:
        tag = f"g{grid_size}o{order}"
        cfg = KANConfig(layers_hidden=KAN_LAYERS, grid_size=grid_size,
                        spline_order=order)
        model = build_model("kan", cfg, fused=True)
        nk = grid_size + 2 * order + 1
        J = nk - order
        params = model.init(torch.Generator().manual_seed(SEED), dev)
        checks = {}
        for label, p in (("init", params), ("refreshed", None)):
            if p is None:  # knots from the data: non-uniform
                p = model.update_grid(params, coords[::-(-n // 4096)])
            flat = [t.detach().contiguous() for t in
                    kf.flatten_kan_params(p)]
            layers = list(zip(flat[0::2], flat[1::2]))
            gout, xs = kf.KAN_FWD(layers, sub, order, mode)
            ref, xr = kf.kan_forward_plain(layers, sub, order, mode)
            cot = (2.0 / sub.shape[0]) * (ref - tsub)
            gk = kf.KAN_BWD(layers, xr, cot, order, mode)
            gp = kf.kan_backward_plain(layers, xr, cot, order, mode)
            gk2 = kf.KAN_BWD(layers, xr, cot, order, mode)
            gout2, _ = kf.KAN_FWD(layers, sub, order, mode)
            torch.cuda.synchronize()
            try:
                ferr, _ = check_kan_outputs(layers, xs, gout, xr, ref, order)
                berr = max(check_kan(a, b, KAN_GRAD_RTOL)
                           for a, b in zip(gk, gp))
                good = (torch.equal(gout, gout2) and all(
                    torch.equal(a, b) for a, b in zip(gk, gk2)))
            except AssertionError as e:
                ferr = berr = float("nan")
                good = False
                log(f"phase29 {tag} {label}: {e}")
            checks[label] = (ferr, berr, good)
            if label == "init":
                keep = (layers, xr, cot)
        # the fit over the whole clip through the entry point
        tc = tloop.TrainConfig(total_steps=steps, scan_chunk=min(steps, 10),
                               update_grid_every=every)
        kf.KAN_FWD.launches = kf.KAN_BWD.launches = 0
        res = tloop.fit(model, x, y, tc, state=tloop_init(torch, model, tc,
                                                          dev), device=dev)
        launches = {"kan_fwd": kf.KAN_FWD.launches,
                    "kan_bwd": kf.KAN_BWD.launches}
        # timings over the whole clip (the kernels) and on the subset
        # (kernels and plain versions)
        flat = [t.detach().contiguous()
                for t in kf.flatten_kan_params(params)]
        layers = list(zip(flat[0::2], flat[1::2]))
        g_ms = cuda_ms(torch, lambda: kf.KAN_FWD(layers, coords, order,
                                                 mode), 3)
        _, xf = kf.KAN_FWD(layers, coords, order, mode)
        gfull = torch.ones((n, 1), device=dev) / n
        h_ms = cuda_ms(torch, lambda: kf.KAN_BWD(layers, xf, gfull, order,
                                                 mode), 3)
        # each layer's G and H whole (CUDA events), H on the cotangent ones
        # / n, and the C entries H calls
        stream = torch.cuda.current_stream().cuda_stream
        lib = kf.kan_library(order, nk)()
        per_layer, entries = [], _EntryLog(lib)
        for li, (grid, w_t) in enumerate(layers):
            s = kf._layer_shape(xf[li], grid, w_t, order, li)
            ones = torch.ones((n, s.dout), device=dev) / n
            args = (xf[li], grid, ones, w_t, s, order, mode, stream, li > 0)
            kf.layer_backward(entries, *args)
            per_layer.append((li, s.din, s.dout, kf.fwd_plan(
                s.din, s.dout, J, mode, s.ks).route, kf.dw_plan(
                n, s.din, s.dout, J, mode, s.ks, s.wide).route, cuda_ms(
                torch, lambda: kf.KAN_FWD([(grid, w_t)], xf[li], order,
                                          mode), 3), cuda_ms(
                torch, lambda: kf.layer_backward(lib, *args), 3)))
            del ones, args
        wide = kf.is_wide(order, nk)
        h_kernels = sorted({KAN_ENTRY_KERNELS[e] for e in entries.called})
        del xf, gfull
        slayers, sxr, scot = keep
        sg_ms = cuda_ms(torch, lambda: kf.KAN_FWD(slayers, sub, order, mode),
                        3)
        sg_plain = cuda_ms(torch, lambda: kf.kan_forward_plain(
            slayers, sub, order, mode), 2)
        sh_ms = cuda_ms(torch, lambda: kf.KAN_BWD(slayers, sxr, scot, order,
                                                  mode), 3)
        sh_plain = cuda_ms(torch, lambda: kf.kan_backward_plain(
            slayers, sxr, scot, order, mode), 2)
        bounds = kan_bounds(n, KAN_LAYERS, n_coef=J - 1, order=order)
        sbounds = kan_bounds(sub.shape[0], KAN_LAYERS, n_coef=J - 1,
                             order=order)
        ok = (all(c[2] for c in checks.values())
              and np.isfinite(res.loss_history).all()
              and launches["kan_fwd"] == steps
              and launches["kan_bwd"] == steps)
        out[tag] = dict(J=J, wide=wide, launches=launches,
                        fwd_err=checks["init"][0], bwd_err=checks["init"][1],
                        g_ms=g_ms, h_ms=h_ms, bounds=bounds, sub_rows=int(
                            sub.shape[0]), sub_g_ms=sg_ms,
                        sub_g_plain=sg_plain, sub_h_ms=sh_ms,
                        sub_h_plain=sh_plain, sub_bounds=sbounds,
                        steps_s=res.steps_per_sec,
                        h_kernels=h_kernels, g_kernels=sorted(
                            {"kan_split_kernel"} | {
                                {"tc": "kan_fwd_tc_kernel",
                                 "narrow": "kan_fwd_narrow_kernel",
                                 "fma": "kan_fwd_kernel"}[r]
                                for *_, r, _, _, _ in per_layer}))
        log(f"phase29 KAN{KAN_LAYERS} grid {grid_size} order {order} (J "
            f"{J}, {'wide' if out[tag]['wide'] else 'default'} library): "
            f"vs plain on {sub.shape[0]} rows " + "; ".join(
                f"{lab}: G max abs {c[0]:.3e}, H max abs {c[1]:.3e}, repeats "
                f"bit-equal {c[2]}" for lab, c in checks.items())
            + f"; fit {steps} steps over {n} rows (grid refresh every "
            f"{every or 'never'}) {res.steps_per_sec:.2f} steps/s, final "
            f"loss {float(res.loss_history[-1]):.6g}, launches {launches}; "
            f"whole clip G {g_ms:.3f} ms (bound {bounds[0][0]:.3f} ms, "
            f"{bounds[0][1]}), H {h_ms:.3f} ms (bound {bounds[1][0]:.3f} ms,"
            f" {bounds[1][1]}); per layer " + ", ".join(
                f"{li} ({di}->{do}, G {fr} {gm:.3f} ms, H {hr} {hm:.3f} ms)"
                for li, di, do, fr, hr, gm, hm in per_layer)
            + f"; on the subset G {sg_ms:.3f} ms (plain {sg_plain:.3f}), H "
            f"{sh_ms:.3f} ms (plain {sh_plain:.3f}); "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fails.append(tag)
        del keep, slayers, sxr, scot
    if fails:
        raise AssertionError(f"phase 29 failed: {fails}")
    return out


def build_kernels():
    """Phase 0: every CUDA source built at once (one nvcc each, in threads),
    with ptxas's register and spill lines printed."""
    from inraudio_tpu_torch.ops import kan_fused as kf
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.ops._nvcc import library_path
    builds = {"siren_stack": sf.SIREN_STACK.library,
              "siren_train": st.TRAIN_LIBRARY, "kan": kf.KAN_LIBRARY,
              "kan_wide": kf.KAN_WIDE_LIBRARY}
    # (source, extra nvcc defines) of each library
    sources = {name: (name + ".cu", ()) for name in builds}
    sources["kan_wide"] = ("kan.cu", kf.KAN_WIDE_LIBRARY.defines)
    build_s, failures = {}, []

    def build(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # reported and re-raised below
            failures.append(f"{name}: {e}")
        build_s[name] = time.perf_counter() - t

    threads = [threading.Thread(target=build, args=item)
               for item in builds.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    for name in builds:
        src, defines = sources[name]
        lib = library_path(name, [src], defines)
        log(f"build: {src} {' '.join(defines)} -> {lib.relative_to(HERE)} "
            f"in {build_s[name]:.1f} s")
        for line in ptxas_lines((lib.parent / "build.log").read_text()):
            log(f"  ptxas: {line}")
    # the tensor-core kernels (G's and H's, the SIREN grad kernel's sweep
    # and dW in every bf16 tier, and the stack forward's at every width):
    # their SASS must hold HMMA / HGMMA
    for lib_name, marks in (("kan", ("kan_fwd_tc_kernel",
                                     "kan_bwd_tc_kernel",
                                     "kan_bwd_ws_kernel",
                                     "kan_dx_tc_kernel")),
                            ("kan_wide", ("kan_fwd_tc_kernel",
                                          "kan_bwd_tc_kernel",
                                          "kan_bwd_ws_kernel",
                                          "kan_dx_tc_kernel")),
                            ("siren_train", ("siren_sweep_kernel",
                                             "siren_dw_kernel")),
                            ("siren_stack", ("siren_stack_tc_kernel",))):
        counts = sass_mma_counts(library_path(lib_name,
                                              [sources[lib_name][0]],
                                              sources[lib_name][1]))
        if counts is None:
            log("  sass: the toolkit has no cuobjdump beside nvcc; the HMMA "
                "count of the tensor-core kernels is not read")
            return
        tc = {name: c for name, c in counts.items()
              if any(m in name for m in marks)}
        for name, c in tc.items():
            log(f"  sass: {c} HMMA/HGMMA instructions in {name}")
        if lib_name == "siren_stack":
            lib = library_path(lib_name, [lib_name + ".cu"])
            for line in ptxas_lines((lib.parent / "build.log").read_text()):
                if "siren_stack_tc_kernel" in line:
                    log(f"  stack tc kernel registers: {line}")
        for m in marks:
            if not any(m in name for name in tc):
                raise RuntimeError(f"{lib_name}: no {m} instance in the SASS")
        if not all(c > 0 for c in tc.values()):
            raise RuntimeError(f"{lib_name}: a tensor-core kernel holds no "
                               "HMMA/HGMMA")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "inraudio_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "inraudio_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from inraudio_tpu_torch import codec
    from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.train.multi_inr import (MultiINRConfig,
                                                    chunk_eval_fn,
                                                    chunk_signal)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_cuda import (BF16_BULK_ATOL, BF16_BULK_SHARE,
                                 BF16_MAX_ATOL, F32_ATOL, check_close)

    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return sharded_fits_rank(torch)

    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # ---- phase 0: build, one nvcc per source, all started together ----
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    build_kernels()

    clip = synth_clip(np)
    payloads = {}
    for name, spec in SHAPES.items():
        payloads[name] = make_payload(name, spec, clip, torch, np, codec,
                                      build_model, SirenSnakeTanhConfig,
                                      MultiINRConfig, chunk_signal)

    def tier_kwargs(tier, cfg):
        """The decode's tier for a header with TIER_FITS[tier] as fit."""
        return sf.auto_decode_kwargs(
            TIER_FITS[tier] + codec._FIT_EST_SLACK_DB,
            first_omega_0=cfg.first_omega_0)

    # ---- phase 1: kernel vs plain per tier, both shapes ----
    log(f"tolerances: f32 tiers max-abs <= {F32_ATOL}; bf16 tiers max-abs "
        f"<= {BF16_MAX_ATOL} and >= {BF16_BULK_SHARE:.0%} of outputs within "
        f"{BF16_BULK_ATOL}")
    errs = {}
    for name, (path, payload, cfg) in payloads.items():
        params = codec.dequantize_inr_params(payload["params"], dev)
        coords = torch.from_numpy(
            codec._decode_grid(payload["meta"]["chunk_length"], 1)).to(dev)
        for tier in TIER_FITS:
            kw = tier_kwargs(tier, cfg)
            plan = sf.stack_plan(cfg, **kw)
            route = sf.stack_launch(plan, 128, coords.shape[0]).route
            out = sf.fused_siren_apply_stacked(params, cfg, coords, **kw)
            ref = sf.stack_forward_plain(params, plan, coords)
            torch.cuda.synchronize()
            err = check_close(out, ref, kw)
            errs[(name, tier)] = err
            log(f"phase1 {name} tier={tier} route={route} kwargs={kw} "
                f"max_abs_err={err:.3e} "
                f"out_absmax={float(ref.abs().max()):.4f}")
        del params

    # ---- phase 2: serving through the entry points ----
    sf.SIREN_STACK.launches = 0
    served = {}
    for name, (path, payload, cfg) in payloads.items():
        served_tier = sf.auto_decode_kwargs(
            codec._routing_fit_snr(payload["meta"]),
            first_omega_0=cfg.first_omega_0)
        t0 = time.perf_counter()
        fs, full = codec.decode(payload, dev)
        t1 = time.perf_counter()
        if fs != FS or full.shape != (CLIP_SAMPLES,) or \
                not np.isfinite(full).all():
            raise AssertionError(f"{name}: bad full decode {fs} {full.shape}")
        seeks = ((0.5, 0.75), (3.0, 3.2), (6.9, 7.0))
        for a, b in seeks:
            _, part = codec.decode_range(payload, a, b, dev)
            if not np.array_equal(part, full[round(a * FS):round(b * FS)]):
                raise AssertionError(f"{name}: decode_range [{a}, {b}) != "
                                     "full decode slice")
        fs2, up = codec.decode(payload, dev, upsample=2)
        if fs2 != 2 * FS or up.shape != (2 * CLIP_SAMPLES,) or \
                not np.isfinite(up).all():
            raise AssertionError(f"{name}: bad upsample=2 decode")
        served[name] = full
        log(f"phase2 {name}: full decode {CLIP_SAMPLES} samples in "
            f"{(t1 - t0) * 1e3:.1f} ms (first call), 3 seeks equal to the "
            f"full slice, upsample=2 -> {up.shape[0]} samples, "
            f"tier={served_tier}")
    launches = sf.SIREN_STACK.launches
    log(f"phase2 kernel launches in the served requests: {launches}")
    if launches < 2 * 5:
        raise AssertionError(f"served decodes launched the kernel {launches}"
                             " times, expected at least 10")
    # the served output against the exact apply on the card, and against
    # the CPU plain path on a small range
    for name, (path, payload, cfg) in payloads.items():
        _, exact = codec.decode(payload, dev, fused=False)
        noise = float(np.mean((served[name] - exact) ** 2))
        snr = 10 * np.log10(float(np.mean(exact ** 2)) / max(noise, 1e-30))
        _, cpu = codec.decode_range(payload, 3.0, 3.01, "cpu", fused=True)
        cpu_err = float(np.max(np.abs(cpu - served[name][132300:132741])))
        log(f"phase2 {name}: kernel decode vs exact apply SNR {snr:.1f} dB; "
            f"vs CPU plain path on [3.0, 3.01) s max_abs_err {cpu_err:.3e}")
        if snr < 60.0 or cpu_err > F32_ATOL:
            raise AssertionError(f"{name}: served decode disagrees with "
                                 "its references")
    wav = os.path.join(WORK, "cli.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "inraudio_tpu_torch", "decode", "--device",
         "cuda", "--input", payloads["codec_default"][0], "--output", wav],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    log(f"phase2 CLI rc={proc.returncode} {proc.stdout.strip()}")
    if proc.returncode != 0:
        raise AssertionError(f"CLI decode failed:\n{proc.stderr}")
    from inraudio_tpu_torch.data import read_wav
    sr, data = read_wav(wav)
    if sr != FS or not np.array_equal(data, served["codec_default"]):
        raise AssertionError("CLI decode differs from the in-process decode")

    # ---- phase 3: card-only tests ----
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-m", "cuda", "tests/test_torch_cuda.py"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"phase3 pytest tests/test_torch_cuda.py rc={proc.returncode} "
        f"{tail[0]}")
    if proc.returncode != 0:
        raise AssertionError(f"card tests failed:\n{proc.stdout[-4000:]}")

    # ---- phase 4: timings ----
    timing = {}
    for name, (path, payload, cfg) in payloads.items():
        params = codec.dequantize_inr_params(payload["params"], dev)
        coords = torch.from_numpy(
            codec._decode_grid(payload["meta"]["chunk_length"], 1)).to(dev)
        samples = payload["meta"]["num_chunks"] * coords.shape[0]
        for tier in ("deg11", "exact"):
            kw = tier_kwargs(tier, cfg)
            plan = sf.stack_plan(cfg, **kw)
            ms = cuda_ms(torch, lambda: sf.fused_siren_apply_stacked(
                params, cfg, coords, **kw), 20)
            plain_ms = cuda_ms(torch, lambda: sf.stack_forward_plain(
                params, plan, coords), 20)
            ms2 = cuda_ms(torch, lambda: sf.fused_siren_apply_stacked(
                params, cfg, coords, **kw), 20)
            timing[(name, tier)] = (min(ms, ms2), plain_ms)
            route = sf.stack_launch(plan, 128, coords.shape[0]).route
            log(f"phase4 {name} tier={tier} route={route}: kernel "
                f"{ms:.3f}/{ms2:.3f} ms "
                f"({samples / min(ms, ms2) / 1e3:.1f} Msamples/s), plain "
                f"{plain_ms:.3f} ms ({samples / plain_ms / 1e3:.1f} "
                f"Msamples/s), {samples} window-samples")
        del params
        on_dev = codec.to_device(payload, dev)
        for label, pl in (("params resident", on_dev), ("from host", payload)):
            codec.decode(pl, dev)
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                codec.decode(pl, dev)
            wall = (time.perf_counter() - t0) / reps
            log(f"phase4 {name} stitched decode ({label}): "
                f"{wall * 1e3:.2f} ms -> {CLIP_SAMPLES / wall / 1e6:.2f} "
                f"Msamples/s")
        # where a resident decode's wall time goes, layer by layer (host
        # clock, synchronised after each device step)
        parts = dict.fromkeys(("dequantize", "forward", "copy to host",
                               "stitch"), 0.0)
        reps = 5
        for _ in range(reps):
            t0 = time.perf_counter()
            meta, model, params = codec._payload_model_params(on_dev, None,
                                                              dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            coords = torch.from_numpy(
                codec._decode_grid(meta["chunk_length"], 1)).to(dev)
            out = chunk_eval_fn(model, coords,
                                codec._routing_fit_snr(meta))(params)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host = out.cpu().numpy()
            t3 = time.perf_counter()
            codec._stitch_outs(on_dev, host, 1)
            t4 = time.perf_counter()
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[key] += dt * 1e3 / reps
        log(f"phase4 {name} resident decode breakdown (ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()))
        del on_dev, params, out

    train = train_phases(np, torch, dev, clip, codec, ss, st, sf)
    kan = kan_phases(np, torch, dev, clip)
    runner = runner_phases(np, torch, dev, clip)
    shard = shard_phases(np, torch, dev, clip)
    width_phases(np, torch, dev, clip)
    serving = serving_phases(np, torch, dev, clip, codec, sf,
                             train["payloads"])
    spectral = spectral_phases(np, torch, dev, clip)
    schedule = schedule_phases(np, torch, dev, clip)
    zoo_phases(np, torch, dev, clip, schedule.pop("params"))
    mesh_loss_phases(np, torch, dev, clip)
    population_phases(np, torch, dev, clip)
    kan_orders = kan_order_phases(np, torch, dev, clip)

    shutil.rmtree(WORK, ignore_errors=True)
    ms, plain_ms = timing[("headline", "deg11")]
    head = payloads["headline"][1]
    n_params = sum(v[0].numel() for layer in head["params"]["layers"]
                   for v in layer.values())
    (stack_b, stack_by), (step_b, step_by), (bwd_b, bwd_by) = siren_bounds(
        head["meta"]["num_chunks"], head["meta"]["chunk_length"], 128,
        n_params)
    (g_b, g_by), (h_b, h_by) = kan["kan_bounds"]
    kan_shape = (f"runner KAN{KAN_LAYERS} over {CLIP_SAMPLES} rows, bf16x3"
                 f", launches from the served CLI fits (phase 9)")
    kernels = {"kernels": [{
        "name": "siren_stack",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_stack.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren.py:428",
        "also_replaces": "inraudio_tpu/ops/pallas_siren.py:288",
        "launches": (launches + train["launches"]["siren_stack"]
                     + serving["launches"]["siren_stack"]),
        "max_abs_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": stack_b,
        "bound_by": stack_by,
        "library_ms": None,
        "shape": "headline k=669 n=512 h=128, deg11 tier",
        "cuda_kernels": STACK_KERNELS,
    }, {
        "name": "siren_step",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_step.py:120",
        "launches": (train["launches"]["siren_step"]
                     + serving["launches"]["siren_step"]),
        "max_abs_err": train["step_err"],
        "ms": train["step_ms"],
        "plain_ms": train["step_plain_ms"],
        "bound_ms": step_b,
        "bound_by": step_by,
        "library_ms": None,
        "shape": "headline k=669 n=512 h=128, one whole train step",
        "cuda_kernels": TC_KERNELS + ADAM_KERNELS,
        "split_ms": train["split"], "adam_ms": train["adam_ms"],
        "adam_bound_ms": train["adam_bound"][0],
    }, {
        "name": "siren_bwd",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_train.py:159",
        "launches": train["launches"]["siren_bwd"],
        "max_abs_err": train["bwd_err"],
        "ms": train["bwd_ms"],
        "plain_ms": train["bwd_plain_ms"],
        "bound_ms": bwd_b,
        "bound_by": bwd_by,
        "library_ms": None,
        "shape": "headline k=669 n=512 h=128, bf16x2 grad tier",
        "cuda_kernels": TC_KERNELS,
    }, {
        "name": "kan_fwd",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/kan.cu",
        "replaces": "inraudio_tpu/ops/pallas_kan.py:75",
        "launches": kan["launches_kan"]["kan_fwd"],
        "max_abs_err": kan["kan_fwd_err"],
        "ms": kan["kan_fwd_ms"],
        "plain_ms": kan["kan_fwd_plain_ms"],
        "bound_ms": g_b,
        "bound_by": g_by,
        "library_ms": None,
        "shape": kan_shape,
        "cuda_kernels": ["kan_split_kernel", "kan_fwd_tc_kernel",
                         "kan_fwd_narrow_kernel"],
    }, {
        "name": "kan_bwd",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/kan.cu",
        "replaces": "inraudio_tpu/ops/pallas_kan.py:194",
        "launches": kan["launches_kan"]["kan_bwd"],
        "max_abs_err": kan["kan_bwd_err"],
        "ms": kan["kan_bwd_ms"],
        "plain_ms": kan["kan_bwd_plain_ms"],
        "bound_ms": h_b,
        "bound_by": h_by,
        "library_ms": None,
        "shape": kan_shape,
    }]}
    served = runner["served"]
    for name, shape in (("runner_mlp", "runner mlp h=256 omega0=22000, raw "
                         "coordinates"),
                        ("runner_mlp_rff", "runner mlp RFF h=256 omega0=22000"
                         f", F={RUNNER_NUM_FREQ} sigma={RUNNER_SIGMA}")):
        t = runner[name]
        (sb_, sby), (db_, dby), (cb_, cby) = t["bounds"]
        shape += f", {CLIP_SAMPLES} rows, launches from phase 12"
        rff = name.endswith("rff")
        kernels["kernels"] += [{
            "name": "siren_stack_rff" if rff else "siren_stack_runner",
            "route": "cuda",
            "source": "inraudio_tpu_torch/csrc/siren_stack.cu",
            "replaces": ("inraudio_tpu/ops/pallas_siren.py:209" if rff
                         else "inraudio_tpu/ops/pallas_siren.py:288"),
            "launches": (served[name]["siren_stack"]
                         + served[name + "_autograd"]["siren_stack"]),
            "max_abs_err": runner[(name, "stack_err")],
            "ms": t["stack"], "plain_ms": t["stack_plain"],
            "bound_ms": sb_, "bound_by": sby, "library_ms": None,
            "shape": shape + ", training forward tier (bf16x3, deg 11)",
            "cuda_kernels": STACK_KERNELS,
        }, {
            "name": "siren_step_" + name.replace("_mlp", ""),
            "route": "cuda",
            "source": "inraudio_tpu_torch/csrc/siren_train.cu",
            "replaces": "inraudio_tpu/ops/pallas_siren_step.py:120",
            "launches": served[name]["siren_step"],
            "max_abs_err": runner[(name, "step_err")],
            "ms": t["step"], "plain_ms": t["step_plain"],
            "bound_ms": db_, "bound_by": dby, "library_ms": None,
            "shape": shape + ", one whole train step",
            "cuda_kernels": TC_KERNELS + ADAM_KERNELS,
            "split_ms": t["split"], "adam_ms": t["adam"],
        }, {
            "name": "siren_bwd_" + name.replace("_mlp", ""),
            "route": "cuda",
            "source": "inraudio_tpu_torch/csrc/siren_train.cu",
            "replaces": "inraudio_tpu/ops/pallas_siren_train.py:159",
            "launches": served[name + "_autograd"]["siren_bwd"],
            "max_abs_err": runner[(name, "bwd_err")],
            "ms": t["bwd"], "plain_ms": t["bwd_plain"],
            "bound_ms": cb_, "bound_by": cby, "library_ms": None,
            "shape": shape + ", bf16x2 grad tier",
            "cuda_kernels": TC_KERNELS,
        }]
        t = shard[name]
        shape = shape.replace("launches from phase 12",
                              "2 ranks sharing the card, launches from the "
                              "sharded fit of phase 15")
        kernels["kernels"] += [{
            "name": "siren_grad_rff" if rff else "siren_grad",
            "route": "cuda",
            "source": "inraudio_tpu_torch/csrc/siren_train.cu",
            "replaces": "inraudio_tpu/ops/pallas_siren_step.py:348",
            "launches": shard["launches"][name]["siren_grad"],
            "max_abs_err": shard[(name, "grad_err")],
            "ms": t["grad"], "plain_ms": t["grad_plain"],
            "bound_ms": t["grad_bound"][0],
            "bound_by": t["grad_bound"][1], "library_ms": None,
            "shape": shape + ", one shard of two (154,112 rows), bf16x2 "
                             "grad tier",
            "cuda_kernels": TC_KERNELS, "split_ms": t["split"],
        }, {
            "name": "siren_adam_rff" if rff else "siren_adam",
            "route": "cuda",
            "source": "inraudio_tpu_torch/csrc/siren_train.cu",
            "replaces": "inraudio_tpu/ops/pallas_siren_step.py:491",
            "launches": shard["launches"][name]["siren_adam"],
            "max_abs_err": shard[(name, "adam_err")],
            "ms": t["adam"], "plain_ms": t["adam_plain"],
            "bound_ms": t["adam_bound"][0], "bound_by": t["adam_bound"][1],
            "library_ms": t["adam_library"],
            "shape": shape + ", clip + Adam + best of one model on the "
                             "all-reduced grads; ms: device time, hot, clip "
                             "0; library: torch.optim.Adam(fused=True)"
                             ".step() without clip or best, device time, "
                             "hot",
            "cuda_kernels": F_KERNELS, "device_ms": t["adam_dev"],
            "host_ms": t["adam_host"],
            "library_flushed_ms": t["adam_library_flushed"],
        }]
    t = spectral["timing"]
    shape = (f"mdct target n={SPECTRAL_N}: {SPECTRAL_ROWS[0]} rows, d=2, "
             f"runner mlp h={RUNNER_H} omega0={RUNNER_OMEGA:g}, the "
             "hearing-threshold mask as the per-row weight")
    kernels["kernels"] += [{
        "name": "siren_step_weighted",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_step.py:120",
        "branch": "has_weight",
        "launches": spectral["served"]["mdct_mask"]["siren_step"],
        "max_abs_err": spectral["step_err"],
        "ms": min(t["step_w"], t["step_w2"]), "plain_ms": t["step_w_plain"],
        "bound_ms": t["bounds"][1][0], "bound_by": t["bounds"][1][1],
        "library_ms": None,
        "shape": shape + ", one whole train step; launches from the "
                         "served fit --method mdct --perceptual-mask "
                         "(phase 22)",
        "cuda_kernels": TC_KERNELS + ADAM_KERNELS,
        "unweighted_ms": t["step"], "split_ms": t["split_w"],
    }, {
        "name": "siren_grad_weighted",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_step.py:348",
        "branch": "has_weight",
        "launches": spectral["sharded_launches"]["siren_grad"],
        "max_abs_err": spectral["grad_err"],
        "ms": t["grad_w"], "plain_ms": t["grad_w_plain"],
        "bound_ms": t["grad_bound"][0], "bound_by": t["grad_bound"][1],
        "library_ms": None,
        "shape": shape + ", one shard of two; launches from the weighted "
                         "fit on 2 ranks sharing the card (phase 22)",
        "cuda_kernels": TC_KERNELS, "unweighted_ms": t["grad"],
    }]
    t, tr = schedule["timing"]["runner_mlp"], schedule["timing"][
        "runner_mlp_rff"]
    shape = (f"runner mlp h={RUNNER_H} omega0={RUNNER_OMEGA:g}, raw "
             f"coordinates, {CLIP_SAMPLES} rows, the precision schedule's "
             f"cheap tier {CHEAP_TIER}")
    kernels["kernels"] += [{
        "name": "siren_step_cheap",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_step.py:120",
        "branch": "tier",
        "launches": schedule["launches_cheap"]["siren_step"],
        "max_abs_err": schedule[("runner_mlp", "step_err")],
        "ms": min(t["step_cheap"], t["step_cheap2"]),
        "plain_ms": t["step_cheap_plain"],
        "bound_ms": t["step_cheap_bound"][0],
        "bound_by": t["step_cheap_bound"][1], "library_ms": None,
        "shape": shape + ", one whole train step; launches: the cheap-tier "
                         "steps of the scheduled one-rank fits (phase 25)",
        "cuda_kernels": TC_KERNELS + ADAM_KERNELS,
        "full_ms": t["step_full"], "split_ms": t["split_cheap"],
        "full_split_ms": t["split_full"],
        "rff_ms": min(tr["step_cheap"], tr["step_cheap2"]),
        "rff_full_ms": tr["step_full"],
        "rff_max_abs_err": schedule[("runner_mlp_rff", "step_err")],
    }, {
        "name": "siren_grad_cheap",
        "route": "cuda",
        "source": "inraudio_tpu_torch/csrc/siren_train.cu",
        "replaces": "inraudio_tpu/ops/pallas_siren_step.py:348",
        "branch": "tier",
        "launches": schedule["launches_cheap"]["siren_grad"],
        "max_abs_err": schedule[("runner_mlp", "grad_err")],
        "ms": t["grad_cheap"], "plain_ms": t["grad_cheap_plain"],
        "bound_ms": t["grad_cheap_bound"][0],
        "bound_by": t["grad_cheap_bound"][1], "library_ms": None,
        "shape": shape + ", one shard of two (154,112 rows); launches: the "
                         "cheap-tier steps of the scheduled fit on 2 ranks "
                         "sharing the card (phase 25)",
        "cuda_kernels": TC_KERNELS, "full_ms": t["grad_full"],
        "rff_ms": tr["grad_cheap"], "rff_full_ms": tr["grad_full"],
        "rff_max_abs_err": schedule[("runner_mlp_rff", "grad_err")],
    }]
    for tag, t in kan_orders.items():
        shape = (f"runner KAN{KAN_LAYERS} at grid {tag[1:tag.index('o')]}, "
                 f"order {tag[tag.index('o') + 1:]} (J {t['J']}, "
                 f"{'wide' if t['wide'] else 'default'} library), bf16x3; "
                 f"ms, plain_ms and bound_ms on a {t['sub_rows']}-row "
                 f"subset of the clip (whole clip: {{}}); launches from the "
                 f"served fit of phase 29")
        for name, line, key, b in (
                ("kan_fwd", "inraudio_tpu/ops/pallas_kan.py:75", "g", 0),
                ("kan_bwd", "inraudio_tpu/ops/pallas_kan.py:194", "h", 1)):
            kernels["kernels"].append({
                "name": f"{name}_{tag}",
                "route": "cuda",
                "source": "inraudio_tpu_torch/csrc/kan.cu",
                "replaces": line,
                "launches": t["launches"][name],
                "max_abs_err": t[name[4:] + "_err"],
                "ms": t[f"sub_{key}_ms"],
                "plain_ms": t[f"sub_{key}_plain"],
                "bound_ms": t["sub_bounds"][b][0],
                "bound_by": t["sub_bounds"][b][1],
                "library_ms": None,
                "shape": shape.format(
                    f"{t[key + '_ms']:.3f} ms against a bound of "
                    f"{t['bounds'][b][0]:.3f} ms"),
                "cuda_kernels": t[key + "_kernels"],
            })
    log(f"nvidia-smi: {nvidia_smi()}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
