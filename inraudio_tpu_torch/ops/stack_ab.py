"""Where the stack kernel's time goes, on one card: the stack forward
(kernels A, B and B-RFF) at the port's shapes, timed on the FMA kernel and
on the tensor-core route at each row tiling it takes, and with parts of
``siren_stack_tc_kernel`` switched off.

    python3 inraudio_tpu_torch/ops/stack_ab.py

Shapes, weights random from seed 0, the deg-11 tier (bf16x3 products):

- headline: k = 669 windows of 512 rows, h = 128, omega0 115 (kernel A);
- runner: k = 1, 308,207 rows, h = 256, omega0 22000, raw coordinates
  (kernel B);
- runner RFF: the same with F = 256 frequencies at sigma 10 (B-RFF).

Variants, each a build of its own (one nvcc each, all started together):
``route`` (csrc/siren_stack.cu as it is), and copies of it in
csrc/build/stack_ab/ with one text patch each: ``fresh`` (the bf16x3
layers' products in fresh accumulators added in f32), ``warps8`` (8 warps
a CTA instead of 16), ``slab32`` (h = 256's W in four stages of 32 rows
instead of two of 64), ``unroll2`` (the product's k16 loop unrolled
twice), and, with one part switched off (their outputs are not results),
``no_mma`` (no layer product), ``no_act`` (the epilogue stores pre + a, no
activation), ``no_split`` (no weight split launch), ``no_w`` (no W
staging), ``no_head`` (no head).  Prints one ``stack_ab {...}`` JSON
line: per shape and variant the ms a call (CUDA events, mean of several
calls after a warm-up) and, for the whole variants, the max |out - the FMA
kernel's out|; the headline's ms on each route in each decode tier of
``siren_fused._DECODE_TIERS`` (``tier0``: bf16, degree 7, ..., ``tier3``:
bf16x3, degree 11); and the tensor-core kernel's ptxas lines of each
build.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "inraudio_tpu_torch", "csrc")

# text patches of csrc/siren_stack.cu: (old, new, occurrences)
PATCHES = {
    "fresh": [("constexpr bool kTcFresh = false;",
               "constexpr bool kTcFresh = true;", 1)],
    "warps8": [("constexpr int kTcWarps = 16;", "constexpr int kTcWarps = 8;",
                1)],
    "slab32": [("constexpr int kTcSlab = 64;", "constexpr int kTcSlab = 32;",
                1)],
    "unroll2": [("#pragma unroll 1  // not unrolled", "#pragma unroll 2  //",
                 1)],
    "no_mma": [("hidden_product<H, kTcFresh>(",
                "if (false) hidden_product<H, kTcFresh>(", 2),
               ("rff_product<H>(", "if (false) rff_product<H>(", 2)],
    "no_act": [("split_bf16(activate(KIND, p[q], omega, sa[col + q], DEG), "
                "hv + q,", "split_bf16(p[q] + sa[col + q], hv + q,", 1)],
    "no_split": [("siren_stack_split_kernel<<<",
                  "if (false) siren_stack_split_kernel<<<", 1)],
    "no_w": [("issue_slab<H>(Ws + (j % C::NST)",
              "if (false) issue_slab<H>(Ws + (j % C::NST)", 1)],
    "no_head": [("for (int r = tid / tpr; r < rows;",
                 "for (int r = tid / tpr; r < 0;", 1)],
}
# the patches whose outputs are results (the others switch a part off)
WHOLE = ("fresh", "warps8", "slab32", "unroll2")


def variant_source(name: str) -> str:
    """csrc/siren_stack.cu with ``name``'s patches, in
    csrc/build/stack_ab/<name>/ beside copies of the headers; returns its
    path relative to csrc/."""
    with open(os.path.join(CSRC, "siren_stack.cu")) as f:
        src = f.read()
    for old, new, count in PATCHES[name]:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} found {src.count(old)} "
                               f"times, expected {count}")
        src = src.replace(old, new)
    rel = os.path.join("build", "stack_ab", name)
    os.makedirs(os.path.join(CSRC, rel), exist_ok=True)
    for header in ("siren_common.cuh", "mma_common.cuh"):
        shutil.copy(os.path.join(CSRC, header), os.path.join(CSRC, rel))
    with open(os.path.join(CSRC, rel, "siren_stack.cu"), "w") as f:
        f.write(src)
    return os.path.join(rel, "siren_stack.cu")


def cuda_ms(torch, fn, iters):
    for _ in range(2):
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


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from inraudio_tpu_torch.experiments.runner import build_arch
    from inraudio_tpu_torch.models import (SirenSnakeTanhConfig, build_model,
                                           rff_init)
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops._nvcc import build_library, library_path

    if not torch.cuda.is_available():
        print("stack_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    builds = {"route": "siren_stack.cu"}
    builds.update({name: variant_source(name) for name in PATCHES})
    libs, failures = {}, []

    def build(name, src):
        try:
            libs[name] = build_library("siren_stack", [src])
        except RuntimeError as e:
            failures.append(f"{name}: {e}")

    threads = [threading.Thread(target=build, args=item)
               for item in builds.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failures:
        raise RuntimeError("\n".join(failures))
    kernel = sf.SIREN_STACK
    real_build, real_launch = sf.build_library, sf.stack_launch
    bound, ptxas = {}, {}
    for v, lib in libs.items():  # each library with its argument types
        sf.build_library = lambda *a, lib=lib: lib
        kernel._lib = None
        bound[v] = kernel.library()
        log = (library_path("siren_stack", [builds[v]]).parent
               / "build.log").read_text()
        ptxas[v], entry = [], ""
        for line in log.splitlines():  # ptxas -v: the tc kernel's lines
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "siren_stack_tc_kernel" in entry and (
                    "spill" in line or "Used" in line):
                ptxas[v].append(line.split(":", 1)[-1].strip())
    sf.build_library = real_build

    dev = torch.device("cuda")
    shapes = {}
    cfg = SirenSnakeTanhConfig(hidden_features=128, num_sine=2, num_snake=2,
                               first_omega_0=115.0, hidden_omega_0=30.0)
    shapes["headline"] = (cfg, build_model("mlp", cfg).init(
        torch.Generator().manual_seed(0), dev, windows=669),
        torch.linspace(-1, 1, 512, device=dev)[:, None], None)
    n = 308_207
    coords = torch.linspace(-1, 1, n, device=dev)[:, None]
    for name, f in (("runner", 0), ("runner_rff", 256)):
        b = (rff_init(torch.Generator().manual_seed(1), 1, f, sigma=10.0,
                      device=dev) if f else None)
        model = build_arch("mlp", 2 * f if f else 1, 256, 2, 2, 0, 22000.0,
                           30.0, 0.5, fused=True, rff_b=b)
        params = model.init(torch.Generator().manual_seed(0), dev)
        params = {"layers": [{k: v[None].contiguous() for k, v in p.items()}
                             for p in params["layers"]]}
        shapes[name] = (model.config, params, coords,
                        None if b is None else sf._prep_rff_bt(b))

    def pass_rows(h, warps):
        wn = min(h // 32, warps // 2)
        return 32 * warps // wn

    def row_options(h, warps):
        step = pass_rows(h, warps)
        top = step if h > 128 else max(step, 256)
        return list(range(step, top + 1, step))

    result = {"device": torch.cuda.get_device_name(0), "ptxas": ptxas}
    for name, (cfg, params, coords, bt) in shapes.items():
        plan = sf.stack_plan(cfg, approx_sin=True, sin_poly_degree=11,
                             rff=bt is not None)
        h, n = sf.kernel_width(cfg.hidden_features), coords.shape[0]
        rows = real_launch(plan, h, n).rows
        variants = [("fma", "route", sf.StackLaunch("fma", 8192 // h, 0, 0))]
        for lib, warps in (("route", 16), ("warps8", 8)):
            variants += [(f"{lib}_rows{r}", lib, sf.StackLaunch("tc", r, 0, 0))
                         for r in row_options(h, warps)]
        variants += [(v, v, sf.StackLaunch("tc", rows, 0, 0))
                     for v in PATCHES if v != "warps8"]
        iters = 10 if name == "headline" else 5
        ref, out = None, {}
        for label, lib, launch in variants:
            kernel._lib = bound[lib]
            sf.stack_launch = lambda *a, launch=launch: launch
            call = lambda: kernel(params, plan, coords, bt)  # noqa: E731
            y = call()
            torch.cuda.synchronize()
            ref = y if ref is None else ref
            out[label] = {"ms": cuda_ms(torch, call, iters)}
            if lib == "route" or lib in WHOLE:
                out[label]["max_abs_vs_fma"] = float((y - ref).abs().max())
        sf.stack_launch = real_launch
        kernel._lib = bound["route"]
        out["plan_rows"] = rows
        result[name] = out
    # the headline in every decode tier: the FMA kernel against the route
    cfg, params, coords, _ = shapes["headline"]
    tiers = {}
    for i, (_, _, kw) in enumerate(sf._DECODE_TIERS):
        kw = {k: (torch.bfloat16 if v == "bfloat16" else v)
              for k, v in kw.items()}
        rows = real_launch(sf.stack_plan(cfg, **kw), 128, 512).rows
        for route, r in (("fma", 8192 // 128), ("tc", rows)):
            launch = sf.StackLaunch(route, r, 0, 0)
            sf.stack_launch = lambda *a, launch=launch: launch
            tiers[f"tier{i}_{route}"] = cuda_ms(
                torch, lambda: sf.fused_siren_apply_stacked(
                    params, cfg, coords, **kw), 10)
    sf.stack_launch = real_launch
    result["headline_tiers"] = tiers
    print("stack_ab " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
